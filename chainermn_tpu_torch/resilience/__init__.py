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

* :mod:`~chainermn_tpu_torch.resilience.preemption`: SIGTERM as a
  flag, a vote across the ranks, then the emergency checkpoint (or the
  serving drain) and exit 75 (:class:`PreemptionGuard`).
* :mod:`~chainermn_tpu_torch.resilience.replicate`: peer-replicated host
  snapshots of each rank's state (:class:`ShardReplicator`), the restore
  quorum (:func:`negotiate_restore`), and the seeded chaos harness
  (:class:`TrainingChaosHarness`).

The exit codes tell :func:`chainermn_tpu_torch.launch.supervise` why a
rank stopped.  :mod:`~chainermn_tpu_torch.resilience.replicate` builds on
the trainer's ``Extension``, and the trainer imports this package, so its
names load on first use.
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
from chainermn_tpu_torch.resilience.preemption import (
    PREEMPTION_EXIT_CODE,
    PreemptionGuard,
    PreemptionInterrupt,
)
from chainermn_tpu_torch.resilience import (
    consistency,
    detector,
    faults,
    guard,
    policy,
    preemption,
)

_REPLICATE = ("REPLICATE_SCHEMA", "ReplicationError", "ShardReplicator",
              "TrainingChaosHarness", "chaos_schedule", "negotiate_restore",
              "pick_quorum", "shard_digest", "should_negotiate")


def __getattr__(name):
    if name == "replicate" or name in _REPLICATE:
        import importlib

        mod = importlib.import_module(
            "chainermn_tpu_torch.resilience.replicate")
        return mod if name == "replicate" else getattr(mod, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


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
    "PreemptionGuard",
    "PreemptionInterrupt",
    "HEALTH_EXIT_CODE",
    "HealthEscalationInterrupt",
    "TrainingHealthGuard",
    "RankDivergedError",
    "VoteResult",
    "majority_vote",
    "tree_digest",
    *_REPLICATE,
    "consistency",
    "detector",
    "faults",
    "guard",
    "policy",
    "preemption",
    "replicate",
]
