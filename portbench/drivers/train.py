"""Training cells: the port's captured data-parallel train step.

Set-up builds one training object, the model with its weights from the
seed, the data-parallel optimizer and the step that
``create_multi_node_optimizer(...).make_train_step`` captures, and drives
it through its first ``check_steps`` steps on distinct batches.  Those
steps give the program's readings: each step's loss, the first
gradient's norm by leaf (from the optimizer's state after one step) and
the weights' change by leaf.  The same object then runs the window,
cycling through the cell's batches, with one synchronisation to keep at
most two steps in flight and one at the end.  After the window (and, in
a traced run, a few more steps under a profiler of the device alone and
as many under one of the host and the device) the program is freed
and the plain reference follows the same first steps in float32 from
the same weights and batches.
"""

from __future__ import annotations

import gc
import time
from typing import Callable, Dict, List, Optional

from portbench import judge
from portbench.reference import exact_fp32
from portbench.reference import optim as ref_optim
from portbench.trace import profile_cost, profiled
from portbench.weights import make_weights

#: steps a window keeps in flight before it waits for the oldest.
IN_FLIGHT = 2


def _optimizer(spec: dict):
    from chainermn_tpu_torch.optimizers import adamw, sgd

    if spec["name"] == "sgd":
        return sgd(spec["lr"], spec.get("momentum"))
    if spec["name"] == "adamw":
        return adamw(spec["lr"], b1=spec["b1"], b2=spec["b2"],
                     eps=spec["eps"], weight_decay=spec["weight_decay"])
    raise ValueError(f"unknown optimizer {spec['name']!r}")


#: where the first step's gradient is in each optimizer's state after
#: that step, and the factor that gives it.
FIRST_GRAD = {"sgd": ("momentum_buffer", lambda spec: 1.0),
              "adamw": ("exp_avg", lambda spec: 1.0 / (1 - spec["b1"]))}


def _norms(torch, views: Dict[str, "torch.Tensor"], scale: float = 1.0
           ) -> Dict[str, float]:
    keys = sorted(views)
    vals = torch.stack([torch.linalg.vector_norm(views[k].float())
                        for k in keys]).tolist()
    return {k: v * scale for k, v in zip(keys, vals)}


def half_batch(loss_fn: Callable) -> Callable:
    """A fault: the loss over the first half of the batch's rows, the
    mean taken over them alone."""
    def half(batch):
        return type(batch)(t[:t.shape[0] // 2] for t in batch)

    return lambda model, batch: loss_fn(model, half(batch))


class Program:
    """The training object of one run, built from the cell and the seed.
    ``loss_wrap`` plants a fault in the loss the step is built from."""

    def __init__(self, run, loss_wrap: Optional[Callable] = None):
        from chainermn_tpu_torch.comm import create_communicator
        from chainermn_tpu_torch.optimizers import create_multi_node_optimizer

        torch, cell, dev = run.torch, run.cell, run.device
        cfg, traffic, fam = cell.config, cell.traffic, cell.family
        self.run = run
        self.comm = create_communicator(
            "xla", device=dev,
            allreduce_grad_dtype=getattr(torch, traffic["grad_wire_dtype"]))
        weights = make_weights(fam.weight_specs(cfg), run.seed, dev, torch)
        model, loss_fn, flags = fam.train_model(cfg, traffic, dev, self.comm)
        fam.load(cfg, model, weights)
        del weights
        if loss_wrap is not None:
            loss_fn = loss_wrap(loss_fn)
        self.model = model
        self.opt = create_multi_node_optimizer(
            _optimizer(traffic["optimizer"]), self.comm)
        self.state = self.opt.init(model)
        self.step_fn = self.opt.make_train_step(loss_fn, **flags)
        self.batches = fam.make_batches(cfg, traffic, run.seed, dev, torch,
                                        rank=self.comm.rank)
        self.steps = 0

    def step(self):
        b = self.batches[self.steps % len(self.batches)]
        self.state, metrics = self.step_fn(self.state, b)
        self.steps += 1
        return metrics

    def first_steps(self, n: int) -> dict:
        """The program's readings over its first ``n`` steps."""
        torch, cell = self.run.torch, self.run.cell
        fam, cfg, spec = cell.family, cell.config, cell.traffic["optimizer"]
        named = dict(self.model.named_parameters())
        with torch.no_grad():
            p0 = {k: p.detach().clone() for k, p in named.items()}
        losses, grad = [], None
        for i in range(n):
            losses.append(self.step()["loss"])
            if i == 0:
                # A step that moved nothing has no state: zero gradient.
                key, scale = FIRST_GRAD[spec["name"]]
                st = self.state.optimizer.state
                grad = _norms(torch, fam.bench_views(cfg, {
                    k: st.get(p, {}).get(key, torch.zeros_like(p))
                    for k, p in named.items()}), scale(spec))
        with torch.no_grad():
            for k, p in named.items():
                p0[k].sub_(p.detach())
            delta = _norms(torch, fam.bench_views(cfg, p0))
        del p0
        return {"losses": [float(x) for x in losses], "grad": grad,
                "delta": delta}

    def release(self) -> None:
        release = getattr(self.step_fn, "release", None)
        if release is not None:
            release()
        self.model = self.opt = self.state = self.step_fn = None
        self.batches = None


def reference_readings(run, batches: List, n: int, rnd=None) -> dict:
    """The plain reference's readings over the first ``n`` steps from the
    seed's weights, in float32 (``rnd``: a lower precision, the
    control)."""
    with exact_fp32(run.torch):
        return _reference_readings(run, batches, n, rnd)


def _reference_readings(run, batches, n, rnd) -> dict:
    torch, cell = run.torch, run.cell
    fam, cfg, traffic = cell.family, cell.config, cell.traffic
    w = make_weights(fam.weight_specs(cfg), run.seed, run.device, torch)
    w0 = {k: v.clone() for k, v in w.items()}
    opt = ref_optim.build(traffic["optimizer"])
    losses, grad = [], None
    for i in range(n):
        loss, g = fam.reference.loss_and_grads(
            w, cfg, batches[i], traffic["reference_rows"], rnd)
        with torch.no_grad():
            opt.step(w, g)
        del g
        losses.append(float(loss))
        if i == 0:
            grad = {}
            for k in w:
                t, scale = opt.first_grad(k)
                grad[k] = float(torch.linalg.vector_norm(t)) * scale
    with torch.no_grad():
        for k in w:
            w0[k].sub_(w[k])
        delta = _norms(torch, w0)
    return {"losses": losses, "grad": grad, "delta": delta}


def _sync(torch, device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def window(run, prog: Program, seconds: float) -> dict:
    """Steps for ``seconds``: at most ``IN_FLIGHT`` in flight, all of them
    finished at the close.  Steps and wall seconds."""
    torch, dev = run.torch, run.device
    _sync(torch, dev)
    t0 = time.perf_counter()
    pending, n = [], 0
    while True:
        prog.step()
        n += 1
        if dev.type == "cuda":
            ev = torch.cuda.Event()
            ev.record()
            pending.append(ev)
            if len(pending) > IN_FLIGHT:
                pending.pop(0).synchronize()
        if time.perf_counter() - t0 >= seconds:
            break
    _sync(torch, dev)
    return {"steps": n, "seconds": time.perf_counter() - t0}


def run(run) -> dict:
    """One run of a training cell: its set-up, window, trace and
    comparison.  Returns the driver's record for the result line."""
    torch, cell, dev = run.torch, run.cell, run.device
    fam, cfg, traffic = cell.family, cell.config, cell.traffic
    n_check = traffic["check_steps"]
    prog = Program(run, loss_wrap=run.fault_loss)
    run.log("program built")
    readings = prog.first_steps(n_check)
    batches = prog.batches
    _sync(torch, dev)
    setup_s = run.since_start()
    run.log("set-up done")
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    win = window(run, prog, run.seconds)
    per_step = fam.items_per_step(traffic) * prog.comm.size
    rec = {
        "kind": "train", "family": cfg["family"],
        "chips": prog.comm.size, "setup_s": setup_s,
        "window_s": win["seconds"], "steps": win["steps"],
        "model_flops": fam.train_flops_per_step(cfg, traffic)
        * prog.comm.size * win["steps"],
        "e2e": {fam.TRAIN_RATE: per_step * win["steps"] / win["seconds"],
                "setup_s": setup_s},
        "attempted": win["steps"], "failed": 0,
    }
    if run.trace and dev.type == "cuda":
        k = traffic["trace_steps"]
        def steps():
            for _ in range(k):
                prog.step()

        rec["trace"] = profiled(torch, steps)
        run.log(profile_cost(rec["trace"], win["seconds"] / win["steps"], k,
                             "step"))
        rec["trace_steps"] = k
        if hasattr(fam, "flash_bound_s"):
            rec["flash_bound_s"] = fam.flash_bound_s(cfg, traffic) * k
    _sync(torch, dev)
    run.log("window done")
    rec["memory_peak_bytes"] = (torch.cuda.max_memory_reserved(dev)
                                if dev.type == "cuda" else 0)
    prog.release()
    del prog
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    ref = reference_readings(run, batches, n_check)
    run.log("reference done")
    numbers = judge.train_numbers(readings, ref)
    rec["numbers"] = {k: numbers[k] for k in judge.TRAIN_NUMBERS}
    rec["where"] = numbers["where"]
    return rec
