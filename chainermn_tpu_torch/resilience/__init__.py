"""Resilience of the port: fault injection
(:mod:`chainermn_tpu_torch.resilience.faults`), which the serving
scheduler hooks every decode iteration and the training loop every
iteration, and the deterministic retry policy of checkpoint I/O
(:mod:`chainermn_tpu_torch.resilience.policy`), the failure detector's
error (:mod:`chainermn_tpu_torch.resilience.detector`), and the exit codes
by which a rank tells :func:`chainermn_tpu_torch.launch.supervise` why it
stopped."""

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
from chainermn_tpu_torch.resilience.detector import PeerFailedError
from chainermn_tpu_torch.resilience.policy import (
    RetryExhaustedError,
    RetryPolicy,
)

#: A rank that stopped after a cooperative preemption exits with this
#: code (``chainermn_tpu/resilience/preemption.py``): always restartable,
#: on its own allowance.
PREEMPTION_EXIT_CODE = 75
#: A rank whose training-health guard escalated past its in-process
#: rollbacks exits with this code (``chainermn_tpu/resilience/guard.py``).
HEALTH_EXIT_CODE = 76

__all__ = [
    "HEALTH_EXIT_CODE",
    "PREEMPTION_EXIT_CODE",
    "PeerFailedError",
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
