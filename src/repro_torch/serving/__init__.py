"""Serving (counterpart of `repro.serving`): the static-batch LM engine, the
slot ring and its scheduler, and HDC-as-a-service (the tenant registry, the
multi-tenant engine and scheduler, the link controller and the adaptive
engine, the fault controller and the fault-tolerant engine). The
continuous LM engine and its scheduler wait for ROADMAP §1, serving."""
from repro_torch.serving.engine import Engine, ServeConfig  # noqa: F401
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
from repro_torch.serving.scheduler import SlotScheduler  # noqa: F401
from repro_torch.serving.slotring import SlotRingEngine, slot_update  # noqa: F401
