"""The failure detector's error of the port
(``chainermn_tpu/resilience/detector.py`` ``PeerFailedError``).

:class:`~chainermn_tpu_torch.hostcomm.HostComm` raises it when a bounded
send or receive against a peer expires or the transport fails.  The
heartbeat detector itself (``FailureDetector``) is ROADMAP Queue 1 item
12.
"""

from __future__ import annotations

from typing import Optional


class PeerFailedError(TimeoutError):
    """A peer rank failed, or a bounded op against it expired.

    Subclasses :class:`TimeoutError`, so call sites that catch a generic
    timeout keep working; carries ``peer`` (the rank that failed), ``op``
    (what the caller was doing), ``rank`` (who observed it) and ``kind``:
    ``"timeout"`` (a bounded wait expired; waiting again is meaningful),
    ``"dead"`` (a detector's verdict) or ``"transport"`` (a socket or
    framing failure)."""

    def __init__(self, peer: int, op: str = "?", rank: Optional[int] = None,
                 reason: str = "", kind: str = "timeout"):
        self.peer = int(peer)
        self.op = op
        self.rank = rank
        self.reason = reason
        self.kind = kind
        who = f"rank {rank}: " if rank is not None else ""
        super().__init__(f"{who}peer rank {self.peer} failed during {op}"
                         + (f" ({reason})" if reason else ""))
