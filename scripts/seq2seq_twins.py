"""Train the JAX seq2seq example and the port's twin side by side on the
CPU and compare their learning curves.

The JAX example (``examples/seq2seq/seq2seq.py``, its model initialized
from ``PRNGKey(0)``) runs once; the twin (``python -m
chainermn_tpu_torch.examples.seq2seq``) runs once per ``--seeds`` value,
its model initialized from that seed.  Both train on the same synthetic
corpus in the same batch order with Adam 3e-3 and end with corpus BLEU
on the same 512 held-out pairs.  Every run is a subprocess, all started
together.  The script prints each run's per-epoch loss and token
accuracy and its BLEU, and writes them with the commands to ``--out``
(JSON).  Run from the repository root::

    python scripts/seq2seq_twins.py --arch lstm --epochs 20
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EPOCH = re.compile(r"^epoch (\d+)\s.*loss ([-\d.]+)\s+token_acc\w* ([-\d.]+)")
BLEU = re.compile(r"^corpus BLEU ([-\d.]+)")


def parse(out: str) -> dict:
    epochs, bleu = [], None
    for line in out.splitlines():
        m = EPOCH.match(line)
        if m:
            epochs.append({"epoch": int(m.group(1)),
                           "loss": float(m.group(2)),
                           "token_accuracy": float(m.group(3))})
        m = BLEU.match(line)
        if m:
            bleu = float(m.group(1))
    return {"epochs": epochs, "bleu": bleu}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="lstm", choices=("lstm", "transformer"))
    ap.add_argument("--epochs", type=int, default=20)
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2],
                    help="the twin's model seeds, one run each")
    ap.add_argument("--threads", type=int, default=2,
                    help="CPU threads per run")
    ap.add_argument("--out", default="result/seq2seq_twins_cpu.json")
    args = ap.parse_args()
    common = ["--arch", args.arch, "--epoch", str(args.epochs),
              "--communicator", "naive"]
    runs = {"jax": [sys.executable, "examples/seq2seq/seq2seq.py",
                    "--force-cpu", *common]}
    for s in args.seeds:
        runs[f"port_seed{s}"] = [
            sys.executable, "-m", "chainermn_tpu_torch.examples.seq2seq",
            "--device", "cpu", "--seed", str(s), *common]
    env = dict(os.environ, PYTHONPATH=ROOT, JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS=str(args.threads),
               XLA_FLAGS=f"--xla_cpu_multi_thread_eigen=false "
                         f"intra_op_parallelism_threads={args.threads}")
    t0 = time.time()
    procs = {k: subprocess.Popen(cmd, cwd=ROOT, env=env, text=True,
                                 stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE)
             for k, cmd in runs.items()}
    result = {"arch": args.arch, "epochs": args.epochs, "runs": {}}
    ok = True
    for k, p in procs.items():
        out, err = p.communicate()
        r = parse(out)
        r.update(command=" ".join(runs[k][1:]), returncode=p.returncode)
        if p.returncode != 0 or len(r["epochs"]) != args.epochs:
            ok = False
            r["stderr_tail"] = err[-2000:]
        result["runs"][k] = r
    result["seconds"] = time.time() - t0
    for k, r in result["runs"].items():
        curve = "  ".join(f"{e['loss']:.4f}/{e['token_accuracy']:.4f}"
                          for e in r["epochs"])
        print(f"{k}: BLEU {r['bleu']}  loss/accuracy per epoch: {curve}")
    os.makedirs(os.path.dirname(os.path.join(ROOT, args.out)) or ".",
                exist_ok=True)
    with open(os.path.join(ROOT, args.out), "w") as f:
        json.dump(result, f, indent=1)
    print(f"wrote {args.out} ({result['seconds']:.0f} s)")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
