"""Radiant core on PyTorch: page-table placement and migration for tiered
memory (twin of the JAX package's ``core``; the reference's ``lane_mesh``
is left out: the port's sweeps run on one device)."""
from .config import (CostConfig, MachineConfig, PolicyConfig, FIRST_TOUCH,
                     INTERLEAVE, MIG_AUTONUMA, MIG_NOMAD, MIG_TPP,
                     PT_BIND_ALL, PT_BIND_HIGH, PT_FOLLOW_DATA,
                     benchmark_machine, bhi, bhi_mig, bind_all, cxl_machine,
                     linux_default, nomad, tpp)
from .sim import (RunResult, TieredMemSimulator, Trace, fault_schedule,
                  fault_step_mask, pad_trace)
from .state import SimState, init_state, is_dram, same_tier
from .sweep import compile_count as sweep_compile_count
from .sweep import stack_policies, sweep, sweep_lanes
from .workloads import TraceSpec, trace_digest
from . import workloads

__all__ = [
    "CostConfig", "MachineConfig", "PolicyConfig", "FIRST_TOUCH",
    "INTERLEAVE", "MIG_AUTONUMA", "MIG_NOMAD", "MIG_TPP",
    "PT_BIND_ALL", "PT_BIND_HIGH", "PT_FOLLOW_DATA",
    "benchmark_machine", "bhi", "bhi_mig", "bind_all", "cxl_machine",
    "linux_default", "nomad", "tpp",
    "RunResult", "TieredMemSimulator", "Trace", "TraceSpec",
    "fault_schedule", "fault_step_mask",
    "pad_trace", "SimState", "init_state", "is_dram", "same_tier",
    "trace_digest", "workloads", "sweep", "sweep_lanes", "stack_policies",
    "sweep_compile_count",
]
