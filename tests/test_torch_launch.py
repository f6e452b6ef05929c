"""The port's launcher (``python -m chainermn_tpu_torch.launch``) and its
global except hook, against the JAX package's
(``chainermn_tpu/launch.py``; ``tests/multiprocess_tests/
test_two_process.py`` runs jobs of two real processes).

Jobs of two ranks run small scripts: the exported environment, the
first failure tearing the job down (a rank blocked forever is killed),
the time limit, ``supervise``'s restart budgets on the exit codes the
port keeps equal to the JAX package's, the ``-m`` module form of the
command line, and an uncaught exception in a rank of a gloo job that
brings down its peer blocked in a collective.
"""

import json
import os
import subprocess
import sys
import textwrap
import time

import pytest

from chainermn_tpu.resilience.guard import HEALTH_EXIT_CODE
from chainermn_tpu.resilience.preemption import PREEMPTION_EXIT_CODE

from chainermn_tpu_torch import launch as tlaunch
from chainermn_tpu_torch import resilience

from torch_process_state import restore_process_state  # noqa: E402,F401
from torch_ranks import REPO

pytestmark = pytest.mark.tier1

ENV_KEYS = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE", "LOCAL_RANK",
            "LOCAL_WORLD_SIZE", "CMN_TPU_HOSTS", "CMN_TPU_RANK",
            "CMN_TPU_HB_HOSTS", "CMN_OBS_FLIGHT_DIR", "CMN_LAUNCH_ATTEMPT")


def _script(tmp_path, name, body):
    p = tmp_path / name
    p.write_text(textwrap.dedent(body))
    return str(p)


def test_exit_codes_equal_the_jax_packages():
    assert resilience.PREEMPTION_EXIT_CODE == PREEMPTION_EXIT_CODE == 75
    assert resilience.HEALTH_EXIT_CODE == HEALTH_EXIT_CODE == 76
    assert tlaunch.TIMEOUT_EXIT_CODE == 124


def test_ranks_get_the_torch_distributed_environment(tmp_path):
    script = _script(tmp_path, "env.py", f"""
        import json, os
        keys = {ENV_KEYS!r}
        json.dump({{k: os.environ.get(k) for k in keys}},
                  open(os.path.join({str(tmp_path)!r},
                                    "env%s.json" % os.environ["RANK"]), "w"))
        """)
    assert tlaunch.supervise(2, [script]) == 0
    envs = [json.loads((tmp_path / f"env{r}.json").read_text())
            for r in range(2)]
    for r, env in enumerate(envs):
        assert (env["RANK"], env["LOCAL_RANK"], env["CMN_TPU_RANK"]) == \
            (str(r),) * 3
        assert env["WORLD_SIZE"] == env["LOCAL_WORLD_SIZE"] == "2"
        assert env["MASTER_ADDR"] == "127.0.0.1"
        assert env["CMN_LAUNCH_ATTEMPT"] == "0"
        assert len(env["CMN_TPU_HOSTS"].split(",")) == 2
        assert env["CMN_OBS_FLIGHT_DIR"].endswith("attempt0")
    for k in ("MASTER_PORT", "CMN_TPU_HOSTS", "CMN_TPU_HB_HOSTS"):
        assert envs[0][k] == envs[1][k]
    ports = {int(h.rsplit(":", 1)[1]) for env in envs[:1] for h in
             env["CMN_TPU_HOSTS"].split(",") + env["CMN_TPU_HB_HOSTS"]
             .split(",")} | {int(envs[0]["MASTER_PORT"])}
    assert len(ports) == 5


def test_first_failure_tears_the_job_down(tmp_path, capfd):
    """Rank 1 exits 3 while rank 0 blocks forever: the job returns 3 at
    once, rank 0 killed (the reference's MPI_Abort contract)."""
    script = _script(tmp_path, "fail.py", """
        import os, time
        if os.environ["RANK"] == "1":
            time.sleep(0.3)
            raise SystemExit(3)
        time.sleep(600)
        """)
    t0 = time.monotonic()
    assert tlaunch.launch(2, [script], grace_s=1.0) == 3
    assert time.monotonic() - t0 < 30
    assert "rank exited with 3" in capfd.readouterr().err


def test_time_limit_stops_the_job(tmp_path):
    script = _script(tmp_path, "hang.py", "import time\ntime.sleep(600)\n")
    t0 = time.monotonic()
    assert tlaunch.launch(2, [script], grace_s=0.5,
                          timeout_s=1.0) == tlaunch.TIMEOUT_EXIT_CODE
    assert time.monotonic() - t0 < 30


def test_supervise_restart_budgets(tmp_path, capfd):
    """Attempt 0 exits with the preemption code, attempt 1 with the
    health code, attempt 2 fails, attempt 3 succeeds: each consumes its
    own allowance, as in the JAX package's ``supervise``."""
    script = _script(tmp_path, "flaky.py", f"""
        import os, sys
        codes = [{PREEMPTION_EXIT_CODE}, {HEALTH_EXIT_CODE}, 1, 0]
        sys.exit(codes[int(os.environ["CMN_LAUNCH_ATTEMPT"])])
        """)
    assert tlaunch.supervise(2, [script], restarts=1, backoff_s=0.0,
                             grace_s=0.5) == 0
    err = capfd.readouterr().err
    for n, kind in enumerate(("preemption", "health", "failure", "ok")):
        assert f"attempt {n}: nproc=2" in err and f"({kind})" in err
    # Without a failure allowance the third attempt's code is the job's.
    assert tlaunch.supervise(2, [script], restarts=0, backoff_s=0.0,
                             grace_s=0.5) == 1


def test_module_form_of_the_command_line(tmp_path):
    pkg = tmp_path / "mod_pkg"
    pkg.mkdir()
    (pkg / "__init__.py").write_text("")
    (pkg / "hello.py").write_text(textwrap.dedent(f"""
        import os, sys
        open(os.path.join({str(tmp_path)!r}, "hello%s" % os.environ["RANK"]),
             "w").write(" ".join(sys.argv[1:]))
        """))
    env = dict(os.environ, PYTHONPATH=f"{tmp_path}:{REPO}")
    proc = subprocess.run(
        [sys.executable, "-m", "chainermn_tpu_torch.launch", "--nproc", "2",
         "--timeout", "60", "-m", "mod_pkg.hello", "--epoch", "2"],
        cwd=str(REPO), env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    for r in range(2):
        assert (tmp_path / f"hello{r}").read_text() == "--epoch 2"


def test_uncaught_exception_brings_the_job_down(tmp_path, capfd):
    """Rank 1 raises after creating a two-rank gloo communicator (which
    installs the except hook); rank 0 waits in a barrier that can never
    complete.  The hook exits rank 1 with 1 and the launcher kills rank 0,
    well inside the 60 s limit."""
    script = _script(tmp_path, "boom.py", """
        from chainermn_tpu_torch.comm import create_communicator
        comm = create_communicator("naive", device="cpu")
        if comm.rank == 1:
            raise ValueError("boom on rank 1")
        comm.barrier()
        """)
    t0 = time.monotonic()
    rc = tlaunch.launch(2, [script], grace_s=1.0, timeout_s=60.0,
                        env_extra={"PYTHONPATH": str(REPO),
                                   "OMP_NUM_THREADS": "1",
                                   "CUDA_VISIBLE_DEVICES": ""})
    assert rc == 1 and time.monotonic() - t0 < 60
    err = capfd.readouterr().err
    assert "ValueError: boom on rank 1" in err
    assert "uncaught exception on rank 1/2" in err
