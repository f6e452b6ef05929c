"""Multi-process launcher of the port: the ``mpiexec`` analog
(``chainermn_tpu/launch.py``).

Reference jobs start as ``mpiexec -n N python train.py``: the MPI runtime
spawns the ranks, wires their bootstrap and kills every rank when one
calls ``MPI_Abort`` (which the global except hook does on an uncaught
exception).  This module is that runtime for one host:

    python -m chainermn_tpu_torch.launch --nproc 4 train.py --epochs 4
    python -m chainermn_tpu_torch.launch --nproc 4 -m chainermn_tpu_torch.examples.train_vgg_model_parallel

It exports what ``torch.distributed`` reads (``MASTER_ADDR``,
``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``LOCAL_WORLD_SIZE``), the object plane's ports (``CMN_TPU_HOSTS``,
``CMN_TPU_RANK``, ``CMN_TPU_HB_HOSTS``) and a per-attempt
``CMN_OBS_FLIGHT_DIR``, and supervises the children: the first non-zero
exit tears the other ranks down (SIGTERM, then SIGKILL of each rank's
process group after a grace period), since a peer blocked in a collective
whose partner died would otherwise wait forever.  ``timeout_s`` bounds
the whole job the same way (exit 124).  :func:`supervise` relaunches on
failure, preemption and health escalation, each on its own allowance.

With ``LOCAL_RANK`` set, :func:`~chainermn_tpu_torch.comm.
create_communicator` picks ``cuda:LOCAL_RANK``, so on a host with one card
per rank each rank gets its own; ranks that share one card pass the
device themselves and use the ``naive`` (gloo) communicator, since NCCL
refuses two ranks on one card.
"""

from __future__ import annotations

import argparse
import os
import signal
import subprocess
import sys
import time
from typing import Optional

from chainermn_tpu_torch.hostcomm import free_port
from chainermn_tpu_torch.resilience import (
    HEALTH_EXIT_CODE,
    PREEMPTION_EXIT_CODE,
)

#: Exit code of a job that :func:`launch` stopped at its time limit (the
#: code ``timeout(1)`` uses).
TIMEOUT_EXIT_CODE = 124


def _flight_dir(env_extra: Optional[dict] = None) -> str:
    """Per-attempt flight-record directory: an explicit
    ``CMN_OBS_FLIGHT_DIR`` wins, else ``$CMN_OBS_DIR|flightrecords`` /
    ``attempt<N>``."""
    env_extra = env_extra or {}
    explicit = env_extra.get("CMN_OBS_FLIGHT_DIR",
                             os.environ.get("CMN_OBS_FLIGHT_DIR"))
    if explicit:
        return explicit
    attempt = env_extra.get("CMN_LAUNCH_ATTEMPT",
                            os.environ.get("CMN_LAUNCH_ATTEMPT", "0"))
    return os.path.join(os.environ.get("CMN_OBS_DIR", "flightrecords"),
                        f"attempt{attempt}")


def _incident_dir(env_extra: Optional[dict] = None) -> str:
    explicit = (env_extra or {}).get(
        "CMN_OBS_INCIDENT_DIR", os.environ.get("CMN_OBS_INCIDENT_DIR"))
    return explicit or os.path.join(_flight_dir(env_extra), "incidents")


def rank_env(rank: int, nproc: int, master_port: int, hosts: str,
             hb_hosts: str, flight_dir: str) -> dict:
    """The variables rank ``rank`` of ``nproc`` gets on one host."""
    return {
        "MASTER_ADDR": "127.0.0.1",
        "MASTER_PORT": str(master_port),
        "RANK": str(rank),
        "WORLD_SIZE": str(nproc),
        "LOCAL_RANK": str(rank),
        "LOCAL_WORLD_SIZE": str(nproc),
        "CMN_TPU_HOSTS": hosts,
        "CMN_TPU_RANK": str(rank),
        "CMN_TPU_HB_HOSTS": hb_hosts,
        "CMN_OBS_FLIGHT_DIR": flight_dir,
    }


def _kill_tree(p: subprocess.Popen) -> None:
    try:
        os.killpg(p.pid, signal.SIGKILL)
    except OSError:
        p.kill()


def launch(nproc: int, argv: list, grace_s: float = 10.0,
           env_extra: Optional[dict] = None,
           timeout_s: Optional[float] = None) -> int:
    """Spawn ``nproc`` ranks of ``python argv``; return the job's exit code
    (0 iff every rank exited 0; the first non-zero code otherwise;
    :data:`TIMEOUT_EXIT_CODE` when ``timeout_s`` ran out first).  On the
    first non-zero exit, or at the time limit, the other ranks are
    terminated."""
    master = free_port()
    hosts = ",".join(f"127.0.0.1:{free_port()}" for _ in range(nproc))
    hb_hosts = ",".join(f"127.0.0.1:{free_port()}" for _ in range(nproc))
    flight_dir = _flight_dir(env_extra)
    procs = []
    for rank in range(nproc):
        env = dict(os.environ)
        env.update(env_extra or {})
        env.update(rank_env(rank, nproc, master, hosts, hb_hosts,
                            flight_dir))
        # Own session per rank: the launcher can kill a rank's whole
        # process tree, and the ranks never get the terminal's signals.
        procs.append(subprocess.Popen([sys.executable] + list(argv),
                                      env=env, start_new_session=True))

    def killall(signum=None, frame=None):
        for p in procs:
            if p.poll() is None:
                _kill_tree(p)
        if signum is not None:
            sys.exit(128 + signum)

    # The launcher being terminated must not orphan its ranks.
    prev_term = signal.signal(signal.SIGTERM, killall)
    prev_int = signal.signal(signal.SIGINT, killall)
    deadline = None if timeout_s is None else time.monotonic() + timeout_s
    failed = None
    try:
        while failed is None:
            codes = [p.poll() for p in procs]
            bad = [c for c in codes if c not in (None, 0)]
            if bad:
                failed = bad[0]
                why = f"rank exited with {failed}"
            elif all(c == 0 for c in codes):
                return 0
            elif deadline is not None and time.monotonic() > deadline:
                failed = TIMEOUT_EXIT_CODE
                why = f"time limit of {timeout_s}s reached"
            else:
                time.sleep(0.1)
        running = sum(p.poll() is None for p in procs)
        sys.stderr.write(f"[chainermn_tpu_torch.launch] {why}; terminating "
                         f"{running} remaining rank(s)\n")
        for p in procs:
            if p.poll() is None:
                p.terminate()
        end = time.monotonic() + grace_s
        for p in procs:
            if p.poll() is None:
                try:
                    p.wait(timeout=max(end - time.monotonic(), 0.1))
                except subprocess.TimeoutExpired:
                    _kill_tree(p)
                    p.wait()
        return failed
    finally:
        killall()
        for p in procs:
            p.wait()
        signal.signal(signal.SIGTERM, prev_term)
        signal.signal(signal.SIGINT, prev_int)


def supervise(nproc: int, argv: list, restarts: int = 0,
              backoff_s: float = 1.0, grace_s: float = 10.0,
              env_extra: Optional[dict] = None,
              restart_nproc: Optional[int] = None,
              preempt_restarts: int = 8, health_restarts: int = 2,
              timeout_s: Optional[float] = None) -> int:
    """Run the job, relaunching it whole on failure, the reference's
    restart-based recovery (SURVEY.md §2.8): up to ``restarts`` times on
    a failure, ``preempt_restarts`` times on
    :data:`~chainermn_tpu_torch.resilience.PREEMPTION_EXIT_CODE` and
    ``health_restarts`` times on
    :data:`~chainermn_tpu_torch.resilience.HEALTH_EXIT_CODE`, each budget
    apart.  Relaunches run ``restart_nproc`` ranks (default ``nproc``);
    every attempt exports ``CMN_LAUNCH_ATTEMPT`` and gets fresh ports.
    Each attempt writes one line to stderr: ``attempt N: nproc=X rc=Y
    (ok|failure|preemption|health) duration=Zs``."""
    attempt = fail_used = preempt_used = health_used = 0
    while True:
        n = nproc if attempt == 0 else (restart_nproc or nproc)
        env = dict(env_extra or {})
        env["CMN_LAUNCH_ATTEMPT"] = str(attempt)
        t0 = time.time()
        rc = launch(n, argv, grace_s=grace_s, env_extra=env,
                    timeout_s=timeout_s)
        kind = ("ok" if rc == 0 else "preemption"
                if rc == PREEMPTION_EXIT_CODE else "health"
                if rc == HEALTH_EXIT_CODE else "failure")
        sys.stderr.write(f"[chainermn_tpu_torch.launch] attempt {attempt}: "
                         f"nproc={n} rc={rc} ({kind}) "
                         f"duration={time.time() - t0:.1f}s\n")
        if rc == 0:
            return 0
        sys.stderr.write(f"[chainermn_tpu_torch.launch] attempt {attempt}: "
                         f"flight records (if any) under {_flight_dir(env)}, "
                         f"incident bundles under {_incident_dir(env)}\n")
        if kind == "preemption":
            if preempt_used >= preempt_restarts:
                return rc
            preempt_used += 1
            used, budget = preempt_used, preempt_restarts
        elif kind == "health":
            if health_used >= health_restarts:
                return rc
            health_used += 1
            used, budget = health_used, health_restarts
        else:
            if fail_used >= restarts:
                return rc
            fail_used += 1
            used, budget = fail_used, restarts
        attempt += 1
        sys.stderr.write(f"[chainermn_tpu_torch.launch] {kind} (rc={rc}); "
                         f"restart {used}/{budget} "
                         f"(n={restart_nproc or nproc}) in {backoff_s:.1f}s\n")
        time.sleep(backoff_s)


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    target = None
    if "-m" in argv:  # everything after the module is the module's
        i = argv.index("-m")
        if i + 1 == len(argv):
            raise SystemExit("launch: -m needs a module name")
        target, argv = ["-m"] + argv[i + 1:], argv[:i]
    ap = argparse.ArgumentParser(
        prog="python -m chainermn_tpu_torch.launch",
        description="mpiexec-analog local multi-process launcher; run "
                    "SCRIPT [ARGS] or -m MODULE [ARGS] on every rank")
    ap.add_argument("--nproc", "-n", type=int, required=True)
    ap.add_argument("--grace", type=float, default=10.0,
                    help="seconds between SIGTERM and SIGKILL on teardown")
    ap.add_argument("--timeout", type=float, default=None,
                    help="seconds after which the whole job is torn down "
                         f"(exit {TIMEOUT_EXIT_CODE})")
    ap.add_argument("--restarts", type=int, default=0,
                    help="relaunch the whole job up to N times on failure")
    ap.add_argument("--restart-backoff", type=float, default=1.0)
    ap.add_argument("--restart-nproc", type=int, default=None,
                    help="world size of relaunch attempts")
    ap.add_argument("--preempt-restarts", type=int, default=8,
                    help="relaunch allowance for preemptions (exit "
                         f"{PREEMPTION_EXIT_CODE}); does not use --restarts")
    ap.add_argument("--health-restarts", type=int, default=2,
                    help="relaunch allowance for training-health "
                         f"escalations (exit {HEALTH_EXIT_CODE})")
    ap.add_argument("script", nargs="?",
                    help="python script to run on every rank")
    ap.add_argument("args", nargs=argparse.REMAINDER)
    ns = ap.parse_args(argv)
    if (target is None) == (ns.script is None):
        ap.error("give a script or -m MODULE")
    if target is None:
        target = [ns.script] + ns.args
    return supervise(ns.nproc, target, restarts=ns.restarts,
                     backoff_s=ns.restart_backoff, grace_s=ns.grace,
                     restart_nproc=ns.restart_nproc,
                     preempt_restarts=ns.preempt_restarts,
                     health_restarts=ns.health_restarts,
                     timeout_s=ns.timeout)

if __name__ == "__main__":
    sys.exit(main())
