"""Run one cell of the port's benchmark once and print its result line.

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``, ``portbench/``
and the port (``chainermn_tpu_torch``).  The cell's driver sets up, runs
the window and judges the outputs against the plain reference; this
module checks for the card, reduces the driver's record to the result
line (end-to-end metrics, or with ``--trace 1`` the per-layer ones and a
breakdown) and prints each number compared beside its limit, on standard
error and as the line's last key.  Exit codes: 0 with a result line; 2
without a card (or fewer than the cell asks for); 3 when the process has
loaded JAX or the JAX package; 1 on any other error.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from dataclasses import dataclass
from typing import Any, Callable, Optional

#: top-level module names a run may not hold once its window has closed.
FORBIDDEN = ("jax", "jaxlib", "flax", "chainermn_tpu")

_T_IMPORT = time.perf_counter()


def process_age() -> float:
    """Seconds since this process started (from ``/proc``; since this
    module's import where that cannot be read)."""
    try:
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return up - start / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _T_IMPORT


@dataclass
class Run:
    """What a driver gets: the cell, the card and the run's arguments,
    and the faults a calibration or a test plants (None in a run)."""

    torch: Any
    cell: Any
    device: Any
    seed: int
    seconds: float
    trace: bool
    start_age: float = 0.0
    t_start: float = 0.0
    fault_loss: Optional[Callable] = None
    fault_tokens: Optional[Callable] = None

    def since_start(self) -> float:
        return self.start_age + time.perf_counter() - self.t_start

    def log(self, what: str) -> None:
        """A line on standard error: how far the run is, and when."""
        print(f"portbench {self.since_start():.2f}s: {what}", file=sys.stderr,
              flush=True)


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def result_line(cell, rec: dict, trace: bool, device: dict) -> tuple:
    """``(result, checks)`` from a driver's record."""
    from portbench import judge

    if trace:
        metrics = {}
        for m in cell.per_layer:
            v = cell.readers[m["name"]](rec)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": rec["e2e"][m["name"]],
                               "unit": m["unit"]}
                   for m in cell.end_to_end}
    correct, checks = judge.verdict(rec["numbers"], cell.limits)
    out = {"correct": correct, "attempted": rec["attempted"],
           "failed": rec["failed"], "metrics": metrics, "device": device}
    if trace and rec.get("trace") is not None:
        from portbench.trace import breakdown

        out["breakdown"] = breakdown(rec["trace"])
    out["checks"] = checks
    return out, checks


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    start_age, t_start = process_age(), time.perf_counter()
    # The program as it is deployed: its observability planes on.
    os.environ["CMN_OBS"] = "1"
    from portbench.cell import find

    cell = find(args.workload)
    # The system under test: a checkout without it fails here.
    import chainermn_tpu_torch  # noqa: F401
    import torch

    if not torch.cuda.is_available():
        print("portbench: no CUDA device; the benchmark runs only on the "
              "card", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"portbench: {args.workload} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    torch.set_num_threads(2)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    run = Run(torch=torch, cell=cell, device=dev, seed=args.seed,
              seconds=args.seconds, trace=bool(args.trace),
              start_age=start_age, t_start=t_start)
    rec = cell.driver.run(run)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: the run loaded {bad}", file=sys.stderr)
        return 3
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
              "count": rec["chips"],
              "memory_peak_bytes": int(rec["memory_peak_bytes"])}
    if args.trace:
        device["busy_s"] = rec["trace"]["busy_s"]
        device["window_s"] = rec["trace"]["window_s"]
    out, checks = result_line(cell, rec, bool(args.trace), device)
    print(json.dumps({k: rec.get(k) for k in (
        "e2e", "numbers", "where", "steps", "window_s", "ticks",
        "memory_peak_bytes")}), file=sys.stderr)
    if rec.get("trace") is not None:
        tr = rec["trace"]
        top = sorted(tr["kernels"].items(), key=lambda kv: -kv[1][0])[:15]
        print(json.dumps({"top": [(n[:90], s, c) for n, (s, c) in top]}),
              file=sys.stderr)
    for k, c in checks.items():
        print(f"check {k}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
