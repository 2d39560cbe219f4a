"""Fault injection (counterpart of `repro.faults`): the `FaultState` of
memory, node and wire faults, the fault models and their registry, the
host-side failover planner and the combo-wire erasure helpers.
`core.scaleout.make_ota_serve` and `make_mt_ota_serve` thread the state
through the serve when built with ``faults=``; `serving.FaultController`
promotes persistently quarantined cores to a failover remap at the step
barrier. `shard_fstate` (the reference's ``fstate_spec``) cuts a model
rank's rows and `gather_fstate` gathers them back at the barrier;
`fstate_shape_structs` gives an empty state's shapes to the dry run
(`launch.dryrun`)."""
from repro_torch.faults.model import (
    FAULTS,
    FaultModel,
    FaultState,
    StaticFaults,
    TransientVoteFaults,
    WearoutFaults,
    fstate_shape_structs,
    gather_fstate,
    get_fault_model,
    healthy_for,
    healthy_state,
    inject,
    live_combo_mask,
    live_majority_labels,
    plan_failover,
    recenter_state,
    register_fault_model,
    sample_stuck_cells,
    sample_word_dropout,
    shard_fstate,
)

__all__ = [
    "FAULTS",
    "FaultModel",
    "FaultState",
    "StaticFaults",
    "TransientVoteFaults",
    "WearoutFaults",
    "fstate_shape_structs",
    "gather_fstate",
    "get_fault_model",
    "healthy_for",
    "healthy_state",
    "inject",
    "live_combo_mask",
    "live_majority_labels",
    "plan_failover",
    "recenter_state",
    "register_fault_model",
    "sample_stuck_cells",
    "sample_word_dropout",
    "shard_fstate",
]
