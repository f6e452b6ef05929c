"""Resilience of the port: fault injection
(:mod:`chainermn_tpu_torch.resilience.faults`), which the serving
scheduler hooks every decode iteration and the training loop every
iteration, and the deterministic retry policy of checkpoint I/O
(:mod:`chainermn_tpu_torch.resilience.policy`)."""

from chainermn_tpu_torch.resilience.faults import (
    FaultInjector,
    FaultSpec,
    FaultSpecError,
    InjectedFault,
    corrupt_params,
    parse_fault_spec,
    poison_batch,
    process_injector,
)
from chainermn_tpu_torch.resilience.policy import (
    RetryExhaustedError,
    RetryPolicy,
)

__all__ = [
    "FaultInjector",
    "FaultSpec",
    "FaultSpecError",
    "InjectedFault",
    "RetryExhaustedError",
    "RetryPolicy",
    "corrupt_params",
    "parse_fault_spec",
    "poison_batch",
    "process_injector",
]
