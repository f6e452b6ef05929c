"""Resilience of the port: so far the host half of fault injection
(:mod:`chainermn_tpu_torch.resilience.faults`), which the serving
scheduler hooks every decode iteration."""

from chainermn_tpu_torch.resilience.faults import (
    FaultInjector,
    FaultSpec,
    FaultSpecError,
    InjectedFault,
    parse_fault_spec,
    process_injector,
)

__all__ = [
    "FaultInjector",
    "FaultSpec",
    "FaultSpecError",
    "InjectedFault",
    "parse_fault_spec",
    "process_injector",
]
