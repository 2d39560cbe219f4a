"""Serving (counterpart of `repro.serving`): the static-batch LM engine, the
slot ring and its scheduler, continuous LM batching (the continuous engine,
chunked prefill and the LM scheduler), and HDC-as-a-service (the tenant
registry, the multi-tenant engine and scheduler, the link controller and
the adaptive engine, the fault controller and the fault-tolerant engine)."""
from repro_torch.serving.engine import (  # noqa: F401
    ChunkedPrefill,
    ContinuousEngine,
    Engine,
    ServeConfig,
)
from repro_torch.serving.hdc import (  # noqa: F401
    AdaptiveHDCEngine,
    FaultController,
    FaultControllerConfig,
    FaultTolerantHDCEngine,
    HDCCompletion,
    HDCEngine,
    HDCRequest,
    HDCScheduler,
    LinkController,
    LinkControllerConfig,
    TenantRegistry,
)
from repro_torch.serving.scheduler import (  # noqa: F401
    Completion,
    Request,
    Scheduler,
    SlotScheduler,
)
from repro_torch.serving.slotring import SlotRingEngine, slot_update  # noqa: F401
