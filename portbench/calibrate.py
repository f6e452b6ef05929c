"""Readings that the limits of ``limits/<workload>.json`` are set from.

    python3 -m portbench.calibrate --workload <name> --seeds 1,2,3 \\
        --seconds <s> --mode program|control|half_batch|token

runs the cell once a seed in one process and prints, a line a seed, the
numbers its comparison reads (``--mode program``: the program as a run
runs it), or those of a control or a fault in the program's place:

* ``control``: the plain reference computed in float8 (e4m3, one scale
  a tensor, forward operands and gradients rounded), the step below the
  configurations' bfloat16.  A training cell's control follows the
  checked steps from the same weights and batches; a serving cell's
  reads, over the same prompts and served tokens as the program's, the
  gap of the token that float8 puts first at each position.
* ``witness`` (training): the plain reference computed in bfloat16,
  the configuration's own precision, in the program's place: what
  rounding alone reads.
* ``half_batch`` (training): the step's loss over the first half of the
  batch's rows, the mean taken over them alone.
* ``token`` (serving): one served token of each sampled request altered
  where it is handed back.

A step that returns its state unchanged reads 1 on the change's gap by
the comparison's own measure and needs no run.  The card is required.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time


def _numbers(run, mode: str) -> dict:
    from portbench import judge
    from portbench.drivers import train
    from portbench.reference.lowp import bf16, e4m3

    cell, torch = run.cell, run.torch
    if cell.traffic["driver"] == "train" and mode in ("control", "witness"):
        fam, cfg, traffic = cell.family, cell.config, cell.traffic
        batches = fam.make_batches(cfg, traffic, run.seed, run.device, torch)
        n = traffic["check_steps"]
        low = train.reference_readings(
            run, batches, n, rnd=e4m3 if mode == "control" else bf16)
        gc.collect()
        torch.cuda.empty_cache()
        ref = train.reference_readings(run, batches, n)
        out = judge.train_numbers(low, ref)
        return {k: out[k] for k in judge.TRAIN_NUMBERS + ("where",)}
    if mode == "half_batch":
        run.fault_loss = train.half_batch
    if mode == "token":
        vocab = cell.family.reference.dims(cell.config)["V"]
        run.fault_tokens = lambda served, picks: alter_tokens(served, picks,
                                                              vocab)
    rec = cell.driver.run(run)
    if mode == "control":
        # A serving cell: the control over the program's own sample, and
        # the token fault planted in that sample.
        from portbench.drivers.serve_closed import reference_gaps

        picks, prompts, served = rec["sample"]
        gaps = reference_gaps(run, picks, prompts, served, rnd=e4m3)
        vocab = cell.family.reference.dims(cell.config)["V"]
        alter_tokens(served, picks, vocab)
        faulted = reference_gaps(run, picks, prompts, served)
        return {"logit_gap": max(gaps), "program": rec["numbers"],
                "token_fault": max(faulted)}
    return {**rec["numbers"], "where": rec.get("where")}


def alter_tokens(served: dict, picks, vocab: int) -> None:
    """A fault: the middle served token of each picked request replaced
    by its neighbour id."""
    for k in picks:
        toks = served[k]
        toks[len(toks) // 2] = (toks[len(toks) // 2] + 1) % vocab


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--mode", default="program",
                    choices=("program", "control", "witness",
                             "half_batch", "token"))
    args = ap.parse_args(argv)
    os.environ["CMN_OBS"] = "1"
    from portbench.cell import find
    from portbench.run import Run

    import torch

    if not torch.cuda.is_available():
        print("portbench.calibrate: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    for seed in (int(s) for s in args.seeds.split(",")):
        cell = find(args.workload)
        run = Run(torch=torch, cell=cell, device=dev, seed=seed,
                  seconds=args.seconds, trace=False,
                  t_start=time.perf_counter())
        t0 = time.perf_counter()
        nums = _numbers(run, args.mode)
        print(json.dumps({"workload": args.workload, "mode": args.mode,
                          "seed": seed, "numbers": nums,
                          "s": time.perf_counter() - t0}), flush=True)
        del run
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
