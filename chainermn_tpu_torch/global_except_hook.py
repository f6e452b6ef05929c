"""Global exception hook of the port: bring the whole job down instead of
leaving it deadlocked (``chainermn_tpu/global_except_hook.py``).

Reference anchor: ``chainermn/global_except_hook.py``
``_add_hook_if_enabled``: an uncaught exception on any rank prints its
traceback and calls ``MPI_Abort``, because the surviving ranks would
otherwise wait forever inside a collective for the dead one.  Here the
hook prints a rank-tagged traceback, writes the flight record
(``CMN_OBS_FLIGHT_DIR``) and exits the process at once with status 1;
the launcher (:mod:`chainermn_tpu_torch.launch`, or ``torchrun``) tears
the other ranks down when the first one exits non-zero.  Both
``sys.excepthook`` and ``threading.excepthook`` are replaced: a worker
thread that dies quietly would leave the main thread blocked in a
collective it was feeding.

:func:`~chainermn_tpu_torch.comm.create_communicator` installs the hook
when the job has more than one rank (after ``torch.distributed`` has
installed its own).  Opt out with ``CHAINERMN_TPU_NO_EXCEPT_HOOK=1``.
"""

from __future__ import annotations

import os
import sys
import threading
import traceback

_hook_installed = False
_prev_excepthook = None
_prev_threading_hook = None


def _rank_tag() -> str:
    try:
        import torch.distributed as dist

        if dist.is_available() and dist.is_initialized():
            return f"rank {dist.get_rank()}/{dist.get_world_size()}"
    except Exception:  # a broken runtime must not hide the traceback
        pass
    return f"rank {os.environ.get('RANK', '?')}"


def _global_except_hook(exctype, value, tb):
    traceback.print_exception(exctype, value, tb)
    try:
        from chainermn_tpu_torch.observability import flight as _flight

        _flight.snapshot_on_crash(value)
    except Exception:  # best effort on the way down
        pass
    sys.stderr.write(f"[chainermn_tpu_torch] uncaught exception on "
                     f"{_rank_tag()}; exiting so that the launcher tears "
                     "the job down\n")
    sys.stderr.flush()
    sys.stdout.flush()
    # No graceful process-group shutdown: it can block against peers
    # stuck in the very collective this rank abandons (MPI_Abort was
    # never graceful either).
    os._exit(1)


def _thread_except_hook(args) -> None:
    """``threading.excepthook``: the same teardown for worker threads;
    ``SystemExit`` in a thread stays the quiet no-op it always was."""
    if args.exc_type is SystemExit:
        return
    sys.stderr.write(f"[chainermn_tpu_torch] uncaught exception in thread "
                     f"{getattr(args.thread, 'name', '?')!r}\n")
    _global_except_hook(args.exc_type, args.exc_value, args.exc_traceback)


def add_hook() -> None:
    global _hook_installed, _prev_excepthook, _prev_threading_hook
    if _hook_installed:
        return
    _prev_excepthook = sys.excepthook
    _prev_threading_hook = threading.excepthook
    sys.excepthook = _global_except_hook
    threading.excepthook = _thread_except_hook
    _hook_installed = True


def remove_hook() -> None:
    """Put back the hooks that :func:`add_hook` replaced."""
    global _hook_installed, _prev_excepthook, _prev_threading_hook
    if _hook_installed:
        sys.excepthook = _prev_excepthook
        threading.excepthook = _prev_threading_hook
        _prev_excepthook = _prev_threading_hook = None
        _hook_installed = False


def add_hook_if_enabled() -> None:
    """Reference anchor ``_add_hook_if_enabled``: install unless
    ``CHAINERMN_TPU_NO_EXCEPT_HOOK`` is set."""
    if os.environ.get("CHAINERMN_TPU_NO_EXCEPT_HOOK"):
        return
    add_hook()
