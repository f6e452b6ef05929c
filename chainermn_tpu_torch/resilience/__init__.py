"""Resilience of the port (``chainermn_tpu/resilience``).

* :mod:`~chainermn_tpu_torch.resilience.detector`: ring heartbeats over
  the host object plane; a wait on a dead peer fails in about one
  heartbeat interval with a :class:`PeerFailedError` naming the peer and
  the op.
* :mod:`~chainermn_tpu_torch.resilience.policy`: the deterministic
  :class:`RetryPolicy` of mesh bootstrap and checkpoint I/O.
* :mod:`~chainermn_tpu_torch.resilience.faults`: ``CMN_FAULT``
  deterministic fault injection (``crash@iter:5``, ``hang@barrier:3``;
  fail-silent: ``nan@grad:5``, ``spike@loss:5``, ``flip@param:7``,
  ``skew@step:3:150ms``), hooked by the serving scheduler every decode
  iteration and by the training loop every iteration.
* :mod:`~chainermn_tpu_torch.resilience.guard` and
  :mod:`~chainermn_tpu_torch.resilience.consistency`: the training-health
  half (fail-silent and fail-slow faults): the in-step anomaly check with
  a skip budget, the cross-rank digest vote that names a diverged replica
  (:class:`RankDivergedError`), rollback to a known-good snapshot, and
  stragglers surfaced over the heartbeats.

The exit codes tell :func:`chainermn_tpu_torch.launch.supervise` why a
rank stopped.  Preemption (``PreemptionGuard``, the emergency checkpoint)
and peer replication are ROADMAP Queue 1 item 12b.
"""

from chainermn_tpu_torch.resilience.detector import (
    ALIVE,
    DEAD,
    SUSPECT,
    DetectorCore,
    FailureDetector,
    PeerFailedError,
)
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
from chainermn_tpu_torch.resilience.consistency import (
    RankDivergedError,
    VoteResult,
    majority_vote,
    tree_digest,
)
from chainermn_tpu_torch.resilience.guard import (
    HEALTH_EXIT_CODE,
    HealthEscalationInterrupt,
    TrainingHealthGuard,
)
from chainermn_tpu_torch.resilience import (
    consistency,
    detector,
    faults,
    guard,
    policy,
)

#: A rank that stopped after a cooperative preemption exits with this
#: code (``chainermn_tpu/resilience/preemption.py``): always restartable,
#: on its own allowance.
PREEMPTION_EXIT_CODE = 75

__all__ = [
    "ALIVE",
    "SUSPECT",
    "DEAD",
    "DetectorCore",
    "FailureDetector",
    "PeerFailedError",
    "FaultInjector",
    "FaultSpec",
    "FaultSpecError",
    "InjectedFault",
    "corrupt_params",
    "parse_fault_spec",
    "poison_batch",
    "process_injector",
    "RetryExhaustedError",
    "RetryPolicy",
    "PREEMPTION_EXIT_CODE",
    "HEALTH_EXIT_CODE",
    "HealthEscalationInterrupt",
    "TrainingHealthGuard",
    "RankDivergedError",
    "VoteResult",
    "majority_vote",
    "tree_digest",
    "consistency",
    "detector",
    "faults",
    "guard",
    "policy",
]
