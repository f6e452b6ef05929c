"""Utilities of the port (``chainermn_tpu/utils/__init__.py``): device
resolution, the Flax weight bridge, the per-rank slices of
``ParallelLM``'s and the tensor-parallel ``TransformerLM``'s parameters,
the ZeRO state's logical view; and profiling, timing and scaling
measurement: :func:`atomic_json_dump`, :func:`sync`, :func:`benchmark`
(honest timing: the card synchronized every iteration), :func:`trace`
(``torch.profiler`` to a log directory), :func:`mfu` and
:func:`flash_mfu_fields` (the device plane's one utilization formula),
:func:`scaling_efficiency` and the :class:`StepTimer` extension.  The
JAX package's ``respect_jax_platforms_env``, ``pvary*`` and
``psum_over_varying`` have no meaning here (no platform config, no
varying-manual-axes types)."""

import contextlib
import json
import os
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from chainermn_tpu_torch.utils.bridge import (
    channel_parallel_params_from_flax,
    channel_parallel_params_to_flax,
    dcgan_params_from_flax,
    flax_leaf_paths,
    flax_shapes,
    lora_params_from_flax,
    lora_params_to_flax,
    lstm_seq2seq_params_from_flax,
    lstm_seq2seq_params_to_flax,
    mlp_params_from_flax,
    mlp_params_to_flax,
    parallel_lm_shard,
    parallel_lm_unshard,
    params_from_flax,
    params_to_flax,
    resnet_params_from_flax,
    resnet_params_to_flax,
    seq2seq_params_from_flax,
    seq2seq_params_to_flax,
    tp_params_from_flax,
    vgg_stage_params_from_flax,
    vgg_stage_params_to_flax,
    vit_params_from_flax,
    vit_params_to_flax,
    zero_logical_from_jax,
    zero_logical_to_jax,
)
from chainermn_tpu_torch.utils.device import resolve_device
from chainermn_tpu_torch.observability.device import (
    PEAK_BF16_FLOPS,
    attention_core_flops,
    mfu_pct as _device_mfu_pct,
)


def atomic_json_dump(obj: Any, path: str, indent: int = 1) -> None:
    """Publish a JSON artifact atomically (``path.tmp``, then a rename):
    a signal or a full disk mid-write never leaves a truncated file that
    a gate on non-emptiness would take as done."""
    tmp = f"{path}.tmp"
    try:
        with open(tmp, "w") as f:
            json.dump(obj, f, indent=indent)
            f.write("\n")
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def _tensors(tree) -> List[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in _tensors(x)]
    return []


def sync(tree: Any) -> None:
    """Wait for the device work behind every tensor of ``tree``:
    ``torch.cuda.synchronize`` on each card they live on (CPU tensors are
    ready when returned)."""
    for dev in {t.device for t in _tensors(tree) if t.is_cuda}:
        torch.cuda.synchronize(dev)


def benchmark(step: Callable, *args, warmup: int = 3, iters: int = 10,
              sync_out: Optional[Callable] = None) -> Dict[str, float]:
    """Time ``step(*args)`` with the card synchronized after every call
    (``sync_out`` picks what to wait for from the return value; default
    all of it).  Returns the mean, min and max seconds per call."""
    pick = sync_out or (lambda out: out)
    for _ in range(warmup):
        sync(pick(step(*args)))
    times: List[float] = []
    for _ in range(iters):
        t0 = time.perf_counter()
        sync(pick(step(*args)))
        times.append(time.perf_counter() - t0)
    return {"mean_s": float(np.mean(times)), "min_s": float(np.min(times)),
            "max_s": float(np.max(times)), "iters": float(iters)}


@contextlib.contextmanager
def trace(logdir: str):
    """A ``torch.profiler`` scope (CPU, and CUDA where there is a card)
    whose trace lands in ``logdir`` for TensorBoard or Perfetto."""
    from torch.profiler import ProfilerActivity, profile, \
        tensorboard_trace_handler

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts,
                 on_trace_ready=tensorboard_trace_handler(logdir)) as prof:
        yield prof


def flash_mfu_fields(base_flops: Optional[float], extra_flops: float,
                     step_time_s: float, n_devices: int = 1,
                     device_kind: Optional[str] = None) -> dict:
    """The artifact fields of an attention-kernel MFU correction:
    ``tflops_flash_uncounted`` (the analytic attention-core work a FLOP
    counter cannot see inside a hand-written kernel,
    :func:`attention_core_flops`) and ``mfu_pct_incl_flash``; empty when
    the card has no peak entry or there is nothing to add."""
    if not base_flops or not extra_flops:
        return {}
    pct = _device_mfu_pct(base_flops + extra_flops, step_time_s, n_devices,
                          device_kind=device_kind)
    if pct is None:
        return {}
    return {"tflops_flash_uncounted": round(extra_flops / 1e12, 3),
            "mfu_pct_incl_flash": round(pct, 2)}


def mfu(program, step_time_s: float, n_devices: int = 1,
        device_kind: Optional[str] = None,
        extra_flops: float = 0.0) -> Optional[float]:
    """Model FLOPs utilization (%) of a step: its FLOPs per execution
    over (step time x per-card bf16 peak x ``n_devices``).  ``program``
    is a :class:`~chainermn_tpu_torch.observability.device.
    WatchedProgram` (its cost model's FLOPs, which include the
    hand-written kernels' analytic work) or a FLOP count.  ``None`` when
    the card has no peak entry or there are no FLOPs."""
    if hasattr(program, "cost_analysis"):
        cost = program.cost_analysis()
        flops = None if cost is None else cost.get("flops")
    else:
        flops = program
    if not flops:
        return None
    return _device_mfu_pct(float(flops) + extra_flops, step_time_s,
                           n_devices, device_kind=device_kind)


def scaling_efficiency(throughputs: Sequence[float],
                       sizes: Sequence[int]) -> List[float]:
    """Per-device throughput retention against the smallest size
    measured: ``eff[i] = (T_i / n_i) / (T_0 / n_0)``."""
    base = throughputs[0] / sizes[0]
    return [float((t / n) / base) for t, n in zip(throughputs, sizes)]


class StepTimer:
    """Trainer extension: prints iterations per second over each interval
    on rank 0 (``.extension`` is the :class:`~chainermn_tpu_torch.
    training.Extension` to attach; ``.rates`` keeps every interval's)."""

    def __init__(self, trigger=(1, "epoch")):
        from chainermn_tpu_torch.training import Extension, _rank

        self._last_t = time.perf_counter()
        self._last_iter = 0
        self.rates: List[float] = []

        def fire(trainer):
            now = time.perf_counter()
            d_iter = trainer.iteration - self._last_iter
            dt = now - self._last_t
            if d_iter and dt > 0:
                self.rates.append(d_iter / dt)
                if _rank(trainer) == 0:
                    print(f"[timer] {d_iter / dt:.2f} iters/sec",
                          flush=True)
            self._last_t, self._last_iter = now, trainer.iteration

        self.extension = Extension(fire, trigger=trigger, name="StepTimer")

__all__ = ["PEAK_BF16_FLOPS", "StepTimer", "atomic_json_dump",
           "attention_core_flops", "benchmark", "flash_mfu_fields", "mfu",
           "scaling_efficiency", "sync", "trace",
           "channel_parallel_params_from_flax",
           "channel_parallel_params_to_flax", "dcgan_params_from_flax",
           "flax_leaf_paths", "flax_shapes", "lora_params_from_flax", "lora_params_to_flax",
           "lstm_seq2seq_params_from_flax", "lstm_seq2seq_params_to_flax",
           "mlp_params_from_flax", "mlp_params_to_flax", "parallel_lm_shard",
           "parallel_lm_unshard", "params_from_flax",
           "params_to_flax", "resnet_params_from_flax",
           "resnet_params_to_flax", "resolve_device",
           "seq2seq_params_from_flax", "seq2seq_params_to_flax",
           "tp_params_from_flax", "vgg_stage_params_from_flax", "vgg_stage_params_to_flax",
           "vit_params_from_flax", "vit_params_to_flax",
           "zero_logical_from_jax", "zero_logical_to_jax"]
