"""Runs a rank body of ``torch_rank_bodies`` on N gloo ranks on the CPU,
through the port's own launcher, and returns what each rank saved.

The port's multi-rank test files call :func:`run_ranks` once per file
(from a module-scoped fixture) and compare the ranks' results with the
JAX package's.  The ranks import torch and the port only; each runs with
one intra-op thread (``OMP_NUM_THREADS=1``), no card, and the repo on its
path.
"""

import pathlib
import pickle

from chainermn_tpu_torch.launch import launch, supervise

TESTS = pathlib.Path(__file__).resolve().parent
REPO = TESTS.parent

_SCRIPT = """import sys
sys.path.insert(0, {tests!r})
import torch_rank_bodies
torch_rank_bodies.run({name!r}, {out!r})
"""


def run_ranks(name: str, out_dir, nproc: int = 4, timeout_s: float = 150.0,
              env=None, supervised=None):
    """Run ``torch_rank_bodies.<name>`` on ``nproc`` ranks; returns the
    list of the ranks' saved results (rank order).  Fails if the job
    exits non-zero or outlives ``timeout_s``.  ``supervised``: run it
    through ``launch.supervise`` with these allowances (``restarts``,
    ``health_restarts``, ...), each attempt with ``timeout_s``; fails if
    the supervisor's final code is non-zero."""
    out_dir = pathlib.Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    script = out_dir / f"{name}_rank.py"
    script.write_text(_SCRIPT.format(tests=str(TESTS), name=name,
                                     out=str(out_dir)))
    extra = {"PYTHONPATH": str(REPO), "CUDA_VISIBLE_DEVICES": "",
             "OMP_NUM_THREADS": "1", "CMN_OBS_FLIGHT_DIR":
             str(out_dir / "flight"), **(env or {})}
    if supervised is not None:
        rc = supervise(nproc, [str(script)], backoff_s=0.0, grace_s=2.0,
                       env_extra=extra, timeout_s=timeout_s, **supervised)
    else:
        rc = launch(nproc, [str(script)], grace_s=2.0, env_extra=extra,
                    timeout_s=timeout_s)
    if rc != 0:
        raise AssertionError(f"{name} on {nproc} ranks exited {rc} (the "
                             "ranks' output is in the captured stderr)")
    out = []
    for r in range(nproc):
        with open(out_dir / f"{name}.rank{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out
