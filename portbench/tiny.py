"""Cells cut to a size the CPU tests can hold: the same files, drivers and
comparisons, with the configurations' widths and depths and the traffic
shrunk, and the program in float32 so that it agrees with the reference
to rounding."""

from __future__ import annotations

import os
import time

from portbench.cell import Cell, find

#: what each family's configuration and each driver's traffic become.
CONFIG = {
    "resnet": dict(stage_sizes=[1, 1], width=8, num_classes=10,
                   image_size=32),
    # initializer_range scaled by sqrt(1600 / 64): the logits keep the
    # spread they have at the published width.
    "gpt2": dict(n_layer=2, n_embd=64, n_head=2, vocab_size=300,
                 n_positions=128, initializer_range=0.1),
}
TRAFFIC = {
    "train.resnet": dict(batch=8, reference_rows=8),
    "train.gpt2": dict(batch=4, seq_len=32, reference_rows=2),
    "serve_closed.gpt2": dict(clients=6, requests=64, round=8, max_total=128,
                              scale=1.0, preroll_completions=3,
                              check_requests=12),
}
#: a window long enough that a serving run finishes some hundreds of
#: tokens, as many as its comparison needs.
SECONDS = {"train": 0.5, "serve_closed": 3.0}
SERVE_ENGINE = dict(capacity=3, positions_per_slot=128, prefill_chunk=32)
SERVE_LENGTHS = dict(prompt=dict(median=20, min=4),
                     output=dict(median=40, min=20))


def tiny_cell(workload: str) -> Cell:
    cell = find(workload)
    fam = cell.config["family"]
    cell.config.update(CONFIG[fam], compute_dtype="float32")
    t = cell.traffic
    t.update(TRAFFIC[f"{t['driver']}.{fam}"])
    if "grad_wire_dtype" in t:
        t["grad_wire_dtype"] = "float32"
    if "engine" in t:
        t["engine"].update(SERVE_ENGINE)
        for k, v in SERVE_LENGTHS.items():
            t[k].update(v)
    return cell


def cpu_run(workload: str, seed: int = 2 ** 31 + 17, **faults):
    """One run of ``workload``'s tiny cell on the CPU: ``(cell,
    record)``."""
    import torch

    from portbench.run import Run

    os.environ["CMN_OBS"] = "1"
    cell = tiny_cell(workload)
    run = Run(torch=torch, cell=cell, device=torch.device("cpu"), seed=seed,
              seconds=SECONDS[cell.traffic["driver"]], trace=False, t_start=time.perf_counter(),
              **faults)
    return cell, cell.driver.run(run)
