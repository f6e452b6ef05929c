"""The data-parallel optimizer of the port (``chainermn_tpu/optimizers``
``MultiNodeOptimizer``, ``create_multi_node_optimizer``).

The reference's hot loop (SURVEY.md §3.2): forward and backward on each
rank's batch, ``communicator.allreduce_grad``, then the inner optimizer's
update.  The JAX package compiles that loop into one SPMD program per
batch signature; here it runs one process per card, with the gradient
all-reduce as one flat-bucket collective between the backward and the
update.

**Captured once per signature** (the JAX package's compile-once
contract): on a CUDA device the train step, everything from the forward
to the update (forward and backward over the microbatches, the gradient
all-reduce or the int8 error-feedback reduction, double buffering, the
optimizer's update, the EMA and the cross-rank metric means), is captured
as a CUDA graph per batch signature and replayed after that.  The first
call of a signature runs the step eagerly (its update is kept: it builds
the optimizer's state), then two more eager runs on a side stream warm
up the libraries and the allocator, their effects undone from a snapshot,
and then the capture.  Each later call copies the batch into the graph's
static batch buffers and replays.  The watch
(:mod:`chainermn_tpu_torch.observability.device`) records each capture
as a ``train_step`` program, with no budget, as the reference declares
it: an uneven final batch is a legitimate second signature, and its blame
names the changed argument and axis.  ``capture=False`` runs the same
step eagerly on the card, an explicit mode for comparisons; on the CPU
the step always runs eagerly.

The call shape is the JAX package's::

    opt = create_multi_node_optimizer(adamw(3e-4, weight_decay=0.01), comm)
    state = opt.init(model)
    step = opt.make_train_step(lm_loss(model), has_aux=True, accum_steps=k)
    state, metrics = step(state, batch)

with two differences that PyTorch imposes: the state holds the model (its
parameters are updated in place) and the torch optimizer, and a loss
function takes the model where the JAX one takes a parameter tree.  The
model state of a stateful model (sync-BN running statistics) is its
buffers, which the training forward updates in place.

The JAX package's options carry over with its semantics:
``double_buffering`` (the update applies the previous step's reduced
gradients and carries the fresh ones; the carry starts at zeros, which the
first update applies), ``grad_compression="int8_ef"`` (int8 codes on a
scale shared over the ranks, summed in int32, each rank keeping its own
quantization residual), ``ema_decay`` (an fp32 moving average of the
parameters after every update), ``augment`` (a transform of the batch
drawn from a generator seeded by ``(augment_seed, step, rank)``) and the
eager ``update`` facade, which caches one step per loss function and
flags.

The update rules: :func:`sgd` and :func:`adamw` (``torch.optim``; a
scheduled AdamW keeps its learning rate on the card), and, following
optax's arithmetic on the card (:mod:`~chainermn_tpu_torch.optimizers.
rules`), the scheduled SGD, :func:`adafactor`, and the large-batch tier's
:func:`lars` and :func:`lamb` (:mod:`~chainermn_tpu_torch.optimizers.
large_batch`).
"""

from __future__ import annotations

import copy
import functools
import warnings
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import time

import numpy as np
import torch
import torch.nn as nn

from chainermn_tpu_torch.comm.base import CommunicatorBase
from chainermn_tpu_torch.observability import device as _odevice
from chainermn_tpu_torch.optimizers.large_batch import (
    Lamb,
    Lars,
    kernel_mask,
    lamb,
    lars,
    linear_scaled_lr,
    warmup_cosine_schedule,
)
from chainermn_tpu_torch.optimizers.rules import (
    Adafactor,
    LearningRate,
    RMSProp,
    ScheduledSGD,
)

__all__ = ["Adafactor", "Lamb", "Lars", "MultiNodeOptimizer", "RMSProp",
           "TrainState",
           "ZeroMultiNodeOptimizer", "ZeroTrainState", "adafactor", "adamw",
           "augment_generator", "create_multi_node_optimizer",
           "create_zero_optimizer", "ema_model", "int8_ef_codes",
           "int8_ef_mean", "kernel_mask", "lamb", "lars", "linear_scaled_lr",
           "model_parallel_grad_reduce", "reshard_zero_state", "rmsprop",
           "seed_health", "sgd", "warmup_cosine_schedule",
           "zero_clip_by_global_norm"]


def sgd(learning_rate: LearningRate, momentum: Optional[float] = None,
        nesterov: bool = False):
    """``optax.sgd`` as a torch optimizer factory: ``trace = g + momentum
    · trace``, ``p -= lr · trace`` (``nesterov``: ``p -= lr · (g +
    momentum · trace)``), no dampening, no weight decay -- which is
    ``torch.optim.SGD`` with ``dampening=0``; plain SGD when ``momentum``
    is None.  A schedule (a function of the step count, such as
    :func:`warmup_cosine_schedule`) builds :class:`~chainermn_tpu_torch.
    optimizers.rules.ScheduledSGD`, which evaluates it on the card."""
    if callable(learning_rate):
        return functools.partial(ScheduledSGD, learning_rate=learning_rate,
                                 momentum=momentum, nesterov=nesterov)
    return functools.partial(torch.optim.SGD, lr=learning_rate,
                             momentum=momentum or 0.0, dampening=0.0,
                             nesterov=nesterov, weight_decay=0.0)


def rmsprop(learning_rate: LearningRate, decay: float = 0.9,
            eps: float = 1e-8):
    """``optax.rmsprop(learning_rate)`` as a torch optimizer factory
    (:class:`~chainermn_tpu_torch.optimizers.rules.RMSProp`: ``eps``
    inside the square root, as optax adds it); capturable."""
    return functools.partial(RMSProp, learning_rate=learning_rate,
                             decay=decay, eps=eps)


def adafactor(learning_rate: LearningRate,
              shapes: Optional[Dict[torch.Tensor, tuple]] = None):
    """``optax.adafactor(learning_rate)`` as a torch optimizer factory
    (:class:`~chainermn_tpu_torch.optimizers.rules.Adafactor`, optax's
    defaults); capturable.  ``shapes``: the bridge's
    :func:`~chainermn_tpu_torch.utils.bridge.flax_shapes` of the model, so
    that it factors the JAX layout."""
    return functools.partial(Adafactor, learning_rate=learning_rate,
                             shapes=shapes)


def adamw(learning_rate: LearningRate, b1: float = 0.9, b2: float = 0.999,
          eps: float = 1e-8, weight_decay: float = 1e-4):
    """``optax.adamw`` as a torch optimizer factory, with optax's defaults
    (its weight decay is 1e-4 where torch's AdamW defaults to 1e-2).  The
    update is the same: decay and the bias-corrected Adam step both from
    the old parameters, on every parameter (optax's mask is None).  On a
    CUDA device the optimizer is built ``capturable`` (its step count
    lives on the card), so the train step can be captured.  A schedule of
    the step count (such as :func:`warmup_cosine_schedule`) is evaluated
    on the card: the learning rate is a 0-d tensor on the parameters'
    device, rewritten from the optimizer's step count before every
    ``step()``."""
    def build(params):
        params = list(params)
        scheduled = callable(learning_rate)
        lr = (torch.zeros((), dtype=torch.float32, device=params[0].device)
              if scheduled else learning_rate)
        opt = torch.optim.AdamW(
            params, lr=lr, betas=(b1, b2), eps=eps,
            weight_decay=weight_decay,
            capturable=any(p.is_cuda for p in params))
        if scheduled:
            opt.register_step_pre_hook(functools.partial(
                _scheduled_lr, lr=lr, schedule=learning_rate))
        return opt

    return build


def _scheduled_lr(opt, args, kwargs, lr: torch.Tensor,
                  schedule: Callable) -> None:
    """A step pre-hook: ``lr`` <- ``schedule(count)``, ``count`` the
    updates made so far (optax's count: 0 at the first update), read from
    the optimizer's state on its device, so a captured step records it.
    Every group holds ``lr`` itself (a checkpoint's ``load_state_dict``
    puts its own copy there)."""
    count = next((s["step"] for s in opt.state.values() if "step" in s),
                 None)
    lr.copy_(schedule(torch.zeros_like(lr) if count is None else count))
    for g in opt.param_groups:
        g["lr"] = lr


@dataclass
class TrainState:
    """The training state carried across steps: the step count, the model
    (updated in place) and its torch optimizer, and the options' state,
    each ``{parameter name: tensor}`` or None when its option is off:
    ``pending_grads`` (double buffering: the previous step's reduced
    gradients, in the wire dtype when one is set; zeros at init),
    ``ef_residual`` (int8 error feedback: this rank's quantization
    error, device-varying, never broadcast or averaged) and
    ``ema_params`` (the fp32 moving average of the parameters), and
    ``health``, the health check's carry ``[grad_norm_ema,
    healthy_steps_seen, skipped_total]``, a ``(3,)`` fp32 tensor on the
    parameters' device (None until
    :meth:`~chainermn_tpu_torch.resilience.guard.TrainingHealthGuard.bind`
    or :func:`seed_health` seeds it)."""

    step: int
    model: nn.Module
    optimizer: torch.optim.Optimizer
    pending_grads: Optional[Dict[str, torch.Tensor]] = None
    ef_residual: Optional[Dict[str, torch.Tensor]] = None
    ema_params: Optional[Dict[str, torch.Tensor]] = None
    health: Optional[torch.Tensor] = None

    @property
    def params(self) -> Dict[str, torch.Tensor]:
        return dict(self.model.named_parameters())

    @property
    def model_state(self) -> Dict[str, torch.Tensor]:
        """The model's buffers (e.g. sync-BN running statistics)."""
        return dict(self.model.named_buffers())


def seed_health(state: TrainState) -> TrainState:
    """Give ``state`` a zero health carry on its parameters' device
    (``make_train_step(health_check=True)`` needs one) unless it has
    one."""
    if state.health is None:
        dev = next(state.model.parameters()).device
        state.health = torch.zeros(3, dtype=torch.float32, device=dev)
    return state


def ema_model(state: TrainState) -> nn.Module:
    """A copy of ``state.model`` carrying the EMA parameters (cast to each
    parameter's dtype): evaluate or export the Polyak-averaged model
    with it."""
    if state.ema_params is None:
        raise ValueError("the optimizer keeps no EMA (ema_decay=None)")
    model = copy.deepcopy(state.model)
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(state.ema_params[n].to(p.dtype))
    return model


def augment_generator(seed: int, step: int, rank: int,
                      device) -> torch.Generator:
    """The augmentation draw's generator for one step on one rank, seeded
    from ``(seed, step, rank)`` (the role of the JAX package's
    ``_augment_key``): replicas draw independent transforms and the run
    is reproducible, also across a checkpoint resume."""
    words = np.random.SeedSequence([int(seed), int(step), int(rank)]) \
        .generate_state(2, np.uint32)
    g = torch.Generator(device=device)
    g.manual_seed((int(words[0]) << 31) ^ int(words[1]))
    return g


# ------------------------------------------------------------ int8 wire
def int8_ef_codes(c: torch.Tensor, amax: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """int8 codes of ``c`` (fp32) on the shared scale ``s = max(amax,
    1e-30) / 127`` (``amax``: the largest ``|c|`` over every rank, fp32):
    ``(q, s)``, ``q = clip(round(c / s), -127, 127)`` as fp32 (round half
    to even, as ``jnp.round``).  One rank's residual is ``c - q * s``."""
    s = torch.clamp_min(amax.float(), 1e-30) / 127.0
    q = torch.clamp(torch.round(c / s), -127, 127)
    return q, s


def int8_ef_mean(c: torch.Tensor, size: Optional[int] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The int8 error-feedback reduction of one parameter on stacked
    per-rank inputs ``c`` (R, ...) = gradient + residual, fp32, as the
    ranks compute it together (``MultiNodeOptimizer`` runs the same math
    over the wire): ``(mean, codes, residuals)``, the mean ``sum_r q_r *
    s / size`` (the codes summed exactly in int32), the codes ``q`` (R,
    ...) and each rank's new residual ``c_r - q_r * s`` (R, ...)."""
    size = c.shape[0] if size is None else size
    q, s = int8_ef_codes(c, c.abs().amax())
    tot = q.to(torch.int32).sum(0)
    return tot.float() * s / size, q, c - q * s


def _split(x, k: int):
    n = x.shape[0]
    if n % k:
        raise ValueError(f"per-device batch {n} not divisible by "
                         f"accum_steps={k}")
    if isinstance(x, torch.Tensor):
        return list(torch.chunk(x, k))
    return np.split(np.asarray(x), k)


def _microbatches(batch, k: int):
    """``k`` equal microbatches along the leading axis of every array."""
    if k == 1:
        return [batch]
    if isinstance(batch, (tuple, list)):
        parts = [_split(x, k) for x in batch]
        return [type(batch)(p[i] for p in parts) for i in range(k)]
    return _split(batch, k)


def _map_batch(fn, batch):
    """``batch`` with every leaf array replaced by ``fn(leaf)``."""
    if isinstance(batch, (tuple, list)):
        return type(batch)(_map_batch(fn, b) for b in batch)
    if isinstance(batch, dict):
        return {k: _map_batch(fn, v) for k, v in batch.items()}
    return fn(batch)


def _to_device(batch, dev):
    return _map_batch(lambda x: torch.as_tensor(x, device=dev), batch)


def _leaves(batch, path="batch"):
    """``(path, leaf)`` of every leaf array of ``batch``, in order."""
    if isinstance(batch, (tuple, list)):
        for i, b in enumerate(batch):
            yield from _leaves(b, f"{path}[{i}]")
    elif isinstance(batch, dict):
        for k, v in batch.items():
            yield from _leaves(v, f"{path}[{k!r}]")
    else:
        yield path, batch


def _leaf_dtype(x) -> torch.dtype:
    if isinstance(x, torch.Tensor):
        return x.dtype
    return torch.from_numpy(np.asarray(x)[:0]).dtype


#: eager runs of a train step on a side stream before its capture (after
#: the first, kept, eager step of the signature); their effects undone.
CAPTURE_WARMUP = 2

#: one side stream per device for the warm-ups, shared by every step.
_SIDE_STREAMS: Dict[int, "torch.cuda.Stream"] = {}


def _side_stream(dev) -> "torch.cuda.Stream":
    key = dev.index if dev.index is not None else torch.cuda.current_device()
    if key not in _SIDE_STREAMS:
        _SIDE_STREAMS[key] = torch.cuda.Stream(dev)
    return _SIDE_STREAMS[key]


def _check_capturable(opt: torch.optim.Optimizer) -> None:
    for g in opt.param_groups:
        if not g.get("capturable", True):
            raise ValueError(
                f"{type(opt).__name__} was built with capturable=False: "
                "the captured train step needs its state on the card "
                "(build it with capturable=True, as adamw() does on a CUDA "
                "device, or pass make_train_step(..., capture=False))")


def _counted_wrappers():
    """The training path's kernel wrappers, whose launches a captured
    train step records (each counts a launch made under capture in
    ``.captured``)."""
    import importlib

    from chainermn_tpu_torch.ops import conv_fused as _cf

    # The module (``chainermn_tpu_torch.ops`` re-exports a function of the
    # same name).
    _fa = importlib.import_module("chainermn_tpu_torch.ops.flash_attention")

    return (_fa.flash_attention_fwd, _fa.flash_attention_bwd_dkv,
            _fa.flash_attention_bwd_dq, _cf.matmul_affine_fwd)


class _TrainGraph:
    """One train step captured for one batch signature: the graph, its
    static batch buffers, its static metrics and the kernel launches the
    capture recorded per counted wrapper (each replay runs them again)."""

    def __init__(self, graph, batch, metrics, captured):
        self.graph = graph
        self.batch = batch
        self.metrics = metrics
        self.captured = captured


class MultiNodeOptimizer:
    """Wraps a torch optimizer (or a factory ``params -> optimizer`` such
    as :func:`adamw`) with the cross-rank gradient mean, and the JAX
    package's options (see the module docstring)."""

    def __init__(self, actual_optimizer, communicator: CommunicatorBase,
                 double_buffering: bool = False,
                 grad_reduce: Optional[Callable] = None,
                 grad_compression: Optional[str] = None,
                 ema_decay: Optional[float] = None):
        if grad_reduce is not None and not callable(grad_reduce):
            raise TypeError("grad_reduce must be a function of the model "
                            "(see model_parallel_grad_reduce)")
        if ema_decay is not None and not 0.0 < ema_decay < 1.0:
            raise ValueError(f"ema_decay must be in (0, 1), got {ema_decay}")
        if grad_compression not in (None, "int8_ef"):
            raise ValueError(f"grad_compression={grad_compression!r}: "
                             "expected None or 'int8_ef'")
        self.actual = actual_optimizer
        self.comm = communicator
        self.double_buffering = bool(double_buffering)
        self.grad_compression = grad_compression
        self.ema_decay = ema_decay
        # Replaces the communicator's gradient mean (the JAX package's
        # per-leaf seam, here per model: it reduces every gradient of the
        # model in place); model_parallel_grad_reduce is the one the
        # model-parallel chains need.
        self.grad_reduce = grad_reduce
        self._step_cache: Dict[tuple, Callable] = {}

    def init(self, model: nn.Module) -> TrainState:
        """Broadcast rank 0's parameters to every rank (so all replicas
        start equal), build the torch optimizer over them and the options'
        state: zero pending gradients, zero residuals, the EMA at the
        parameters (fp32)."""
        dev = getattr(self.comm, "device", None)
        pdev = next(model.parameters()).device
        if dev is not None and pdev.type != torch.device(dev).type:
            raise ValueError(
                f"the model's parameters are on {pdev} but the "
                f"communicator reduces on {dev}: create both on one device")
        self.comm.bcast_data(model)
        if isinstance(self.actual, torch.optim.Optimizer):
            held = {id(p) for g in self.actual.param_groups
                    for p in g["params"]}
            if held != {id(p) for p in model.parameters()}:
                raise ValueError("the optimizer must hold exactly the "
                                 "model's parameters")
            opt = self.actual
        else:
            opt = self.actual(model.parameters())
        named = list(model.named_parameters())
        wire = getattr(self.comm, "allreduce_grad_dtype", None)
        with torch.no_grad():
            pending = ({n: torch.zeros_like(p, dtype=wire or p.dtype)
                        for n, p in named}
                       if self.double_buffering else None)
            resid = ({n: torch.zeros_like(p) for n, p in named}
                     if self.grad_compression is not None else None)
            # fp32 whatever the parameter dtype: with bf16 parameters a
            # 0.999-decay increment is below bf16's resolution.
            ema = ({n: p.detach().float().clone() for n, p in named}
                   if self.ema_decay is not None else None)
        return TrainState(step=0, model=model, optimizer=opt,
                          pending_grads=pending, ef_residual=resid,
                          ema_params=ema)

    # ------------------------------------------------------------ reduce
    def _int8_ef_reduce(self, state: TrainState) -> None:
        """Replace every gradient by its int8 error-feedback mean over the
        ranks and advance this rank's residuals: one ``max`` all-reduce of
        the per-parameter ``|grad + residual|`` maxima (the shared
        scales), one int32 ``sum`` all-reduce of every code."""
        comm = self.comm
        named = [(n, p) for n, p in state.model.named_parameters()]
        with torch.no_grad():
            cs = []
            for n, p in named:
                g = p.grad if p.grad is not None else torch.zeros_like(p)
                cs.append(g.float() + state.ef_residual[n].float())
            amax = comm.allreduce(torch.stack([c.abs().amax() for c in cs]),
                                  op="max")
            codes = [int8_ef_codes(c, amax[i]) for i, c in enumerate(cs)]
            tot = comm.allreduce(torch.cat(
                [q.to(torch.int32).reshape(-1) for q, _ in codes]), op="sum")
            at, size = 0, comm.size
            for (n, p), c, (q, s) in zip(named, cs, codes):
                k = c.numel()
                y = tot[at:at + k].view(c.shape).float() * s / size
                at += k
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
                p.grad.copy_(y.to(p.grad.dtype))
                state.ef_residual[n].copy_(
                    (c - q * s).to(state.ef_residual[n].dtype))

    # ------------------------------------------------ the step's seams
    def _begin_step(self, state: TrainState) -> None:
        """Before the microbatches' backward: no gradient held."""
        state.optimizer.zero_grad(set_to_none=True)

    def _reduce_grads(self, state: TrainState) -> None:
        """Between the backward and the update: the cross-rank mean (or
        the int8 error-feedback mean, or the model-parallel reducer)."""
        model = state.model
        if self.grad_compression is not None:
            self._int8_ef_reduce(state)
        elif self.grad_reduce is not None:
            self.grad_reduce(model)
        else:
            self.comm.allreduce_grad(model)

    def _swap_pending(self, state: TrainState) -> None:
        """Double buffering, after the reduction: 1-step-stale, apply the
        previous reduced gradients (real zero tensors at the first step,
        which the update applies as optax applies its zero carry) and
        carry the fresh ones, by copies between buffers that keep their
        addresses."""
        if not self.double_buffering:
            return
        with torch.no_grad():
            for n, p in state.model.named_parameters():
                stale = state.pending_grads[n]
                fresh = p.grad.to(stale.dtype, copy=True)
                p.grad.copy_(stale)
                stale.copy_(fresh)

    def _step_state(self, state: TrainState) -> Dict[tuple, torch.Tensor]:
        """Every tensor the step rewrites in place, by a key that names it
        across steps: parameters, buffers, the optimizer's state (by
        parameter and entry) and the options' state."""
        model, opt = state.model, state.optimizer
        params = list(model.parameters())
        out = {("param", i): p.data for i, p in enumerate(params)}
        out.update((("buffer", i), b) for i, b in enumerate(model.buffers()))
        for i, p in enumerate(params):
            for k, v in opt.state.get(p, {}).items():
                if isinstance(v, torch.Tensor):
                    out[("optimizer", i, k)] = v
        for field in ("pending_grads", "ef_residual", "ema_params"):
            opt_state = getattr(state, field)
            if opt_state is not None:
                out.update(((field, n), t) for n, t in opt_state.items())
        return out

    def _state_tensors(self, state: TrainState):
        """Every tensor the step updates in place (the capture's warm-ups
        are undone from a snapshot of them): :meth:`_step_state` and the
        health carry."""
        out = list(self._step_state(state).values())
        if state.health is not None:
            out.append(state.health)
        return out

    @staticmethod
    def _grad_norm(state: TrainState) -> torch.Tensor:
        """The fp32 norm of every reduced gradient."""
        norms = [torch.linalg.vector_norm(p.grad, dtype=torch.float32)
                 for p in state.model.parameters() if p.grad is not None]
        return torch.linalg.vector_norm(torch.stack(norms))

    def _health_gate(self, state: TrainState, saved: dict,
                     loss: torch.Tensor, gnorm: torch.Tensor,
                     spike_factor: float, spike_warmup: int,
                     spike_ema_beta: float) -> dict:
        """The health check after the update, on the card: the verdict
        ``ok = isfinite(loss) & isfinite(gnorm) & ~spike`` over the
        ranks' mean loss and the reduced gradients' norm (so every rank
        reaches the same one), the carry's update (the norm's moving
        average learns from healthy steps only), and a poisoned step made
        a no-op: every tensor of :meth:`_step_state` selects its value
        from before the step (``saved``; an optimizer entry the step
        created, zeros: its lazy initial value).  No host read."""
        h = state.health
        ema_n, seen, skipped = h[0], h[1], h[2]
        finite = torch.isfinite(loss) & torch.isfinite(gnorm)
        spike = ((seen >= spike_warmup) & (ema_n > 0.0)
                 & (gnorm > spike_factor * ema_n))
        ok = finite & ~spike
        okf = ok.float()
        ema_upd = torch.where(
            seen > 0.0,
            ema_n * (1.0 - spike_ema_beta) + gnorm * spike_ema_beta, gnorm)
        new = torch.stack([torch.where(ok, ema_upd, ema_n), seen + okf,
                           skipped + (1.0 - okf)])
        with torch.no_grad():
            for key, t in self._step_state(state).items():
                old = saved.get(key)
                cond = ok if ok.device == t.device else ok.to(t.device)
                t.copy_(torch.where(cond, t, old if old is not None
                                    else torch.zeros_like(t)))
            h.copy_(new)
        return {"step_ok": okf, "grad_norm": gnorm,
                "health_skipped": new[2]}

    # ------------------------------------------------------- train step
    def make_train_step(self, loss_fn: Callable, has_aux: bool = False,
                        stateful: bool = False, accum_steps: int = 1,
                        augment: Optional[Callable] = None,
                        augment_seed: int = 0,
                        health_check: bool = False,
                        spike_factor: float = 10.0, spike_warmup: int = 20,
                        spike_ema_beta: float = 0.1, *,
                        capture: Optional[bool] = None) -> Callable:
        """``step(state, batch) -> (state, metrics)``.

        ``loss_fn(model, batch)`` returns a scalar, or ``(scalar,
        aux_dict)`` with ``has_aux``, or ``(scalar, (aux_dict,
        model_state))`` with ``stateful`` (the model's buffers, updated in
        place by its forward -- sync-BN running statistics).
        ``accum_steps=k`` splits the batch into ``k`` equal microbatches
        whose losses and gradients are mean-accumulated (each weighs
        ``1/k``, the JAX package's contract) before the one gradient
        all-reduce and the update; the model state threads through the
        microbatches in order, as the JAX ``lax.scan`` threads it.
        ``augment(generator, batch) -> batch`` transforms the batch (moved
        to the model's device first) before any split, with the
        generator of :func:`augment_generator` for ``(augment_seed,
        state.step, rank)``.  ``metrics["loss"]`` and the aux scalars are
        averaged over ranks and stay device tensors, one set per step.

        ``health_check`` (the training-health guard's in-step check, the
        JAX package's arithmetic) turns a step whose mean loss or reduced
        gradient norm is not finite, or whose norm exceeds
        ``spike_factor`` times the norm's moving average (``spike_ema_
        beta``, armed after ``spike_warmup`` healthy steps), into a no-op
        for the parameters, the buffers, the optimizer's state and the
        options' state, inside the step (captured too: no host read);
        it needs ``state.health`` (:func:`seed_health`) and adds the
        device metrics ``step_ok``, ``grad_norm`` and ``health_skipped``.

        ``capture`` (keyword only; None: on for a model on a CUDA device)
        captures the step as a CUDA graph per batch signature (see the
        module docstring); ``capture=False`` runs it eagerly.  A captured
        step reads the optimizer's hyperparameters at its capture: a
        changed learning rate is a new signature, captured anew.  The
        returned function carries ``graphs`` (by signature), ``program``
        (the watch's ``train_step`` record) and ``release()``, which
        frees the graphs and their memory."""
        if accum_steps < 1:
            raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
        comm = self.comm
        capturable = getattr(comm, "capturable", True) and getattr(
            self.grad_reduce, "capturable", True)
        decay = self.ema_decay
        prog = _odevice.watch().register("train_step")
        graphs: Dict[tuple, _TrainGraph] = {}
        held: Dict[str, nn.Module] = {}

        def body(state: TrainState, batch: Any) -> dict:
            """Forward to update on a device batch: the step's device
            work, the same eagerly and under capture (no host reads; the
            double-buffering carry keeps its addresses)."""
            model, opt = state.model, state.optimizer
            if health_check:
                if state.health is None:
                    raise ValueError(
                        "health_check=True needs a seeded state.health "
                        "carry: attach the guard with "
                        "TrainingHealthGuard.bind(trainer), or call "
                        "optimizers.seed_health(state)")
                # Before the forward: it rewrites the buffers.
                saved = {k: t.clone()
                         for k, t in self._step_state(state).items()}
            self._begin_step(state)
            loss_sum, aux_sum = None, {}
            for mb in _microbatches(batch, accum_steps):
                out = loss_fn(model, mb)
                if stateful:
                    loss, (aux, _) = out
                else:
                    loss, aux = out if has_aux else (out, {})
                (loss / accum_steps).backward()
                loss = loss.detach()
                loss_sum = loss if loss_sum is None else loss_sum + loss
                for k, v in aux.items():
                    v = torch.as_tensor(v).detach()
                    aux_sum[k] = v if k not in aux_sum else aux_sum[k] + v
            self._reduce_grads(state)
            gnorm = self._grad_norm(state) if health_check else None
            self._swap_pending(state)
            metrics = {"loss": comm.allreduce(loss_sum / accum_steps,
                                              op="mean")}
            for k, v in aux_sum.items():
                metrics[k] = comm.allreduce(v / accum_steps, op="mean")
            opt.step()
            if decay is not None:
                with torch.no_grad():
                    for n, p in model.named_parameters():
                        e = state.ema_params[n]
                        e.mul_(decay).add_(p.float() * (1.0 - decay))
            if health_check:
                metrics.update(self._health_gate(
                    state, saved, metrics["loss"], gnorm, spike_factor,
                    spike_warmup, spike_ema_beta))
            return metrics

        def signature(state: TrainState, batch: Any):
            """The step's signature: each batch leaf's shape and dtype,
            the optimizer's hyperparameters (a captured step bakes them
            in) and the model's mode; as a lookup key and as the watch's
            named arguments."""
            hyper = repr([{k: v for k, v in g.items() if k != "params"
                           and isinstance(v, (bool, int, float, tuple))}
                          for g in state.optimizer.param_groups])
            mode = "train" if state.model.training else "eval"
            leaves = list(_leaves(batch))
            key = (tuple((path, tuple(np.shape(x)), _leaf_dtype(x))
                         for path, x in leaves), hyper, mode)
            return key, {**dict(leaves), "optimizer": hyper, "mode": mode}

        def captured_step(state: TrainState, batch: Any, dev) -> dict:
            key, args = signature(state, batch)
            g = graphs.get(key)
            if g is not None:
                for (_, dst), (_, src) in zip(_leaves(g.batch),
                                              _leaves(batch)):
                    dst.copy_(torch.as_tensor(src), non_blocking=True)
                g.graph.replay()
                prog.replays += 1
                # The graph rewrites its metrics at every replay.
                return {k: v.clone() for k, v in g.metrics.items()}
            _check_capturable(state.optimizer)
            t0 = time.perf_counter()
            static = _map_batch(
                lambda x: torch.as_tensor(x, device=dev).clone(), batch)
            # The signature's first step runs eagerly and is kept (it
            # builds the optimizer's state); then warm-ups from a
            # snapshot, undone, and the capture, which runs nothing.
            metrics = body(state, static)
            live = self._state_tensors(state)
            saved = [t.clone() for t in live]
            cur = torch.cuda.current_stream(dev)
            side = _side_stream(dev)
            side.wait_stream(cur)
            with torch.cuda.stream(side):
                for _ in range(CAPTURE_WARMUP):
                    body(state, static)
            cur.wait_stream(side)
            with torch.no_grad():
                for t, v in zip(live, saved):
                    t.copy_(v)
            del saved
            wrappers = _counted_wrappers()
            before = [w.captured for w in wrappers]
            graph = torch.cuda.CUDAGraph()
            state.optimizer.zero_grad(set_to_none=True)
            with torch.cuda.graph(graph):
                out = body(state, static)
            graphs[key] = _TrainGraph(
                graph, static, out,
                {w.__name__: w.captured - b
                 for w, b in zip(wrappers, before)})
            held["model"] = state.model
            torch.cuda.synchronize(dev)
            _odevice.watch().record(prog, key, args,
                                    time.perf_counter() - t0, "capture")
            return metrics

        def step(state: TrainState, batch: Any):
            dev = next(state.model.parameters()).device
            if augment is not None:
                # Before the graph: the generator is seeded per step on
                # the host, which a capture would bake in.
                batch = augment(augment_generator(augment_seed, state.step,
                                                  comm.rank, dev),
                                _to_device(batch, dev))
            on = dev.type == "cuda" and capturable if capture is None \
                else bool(capture)
            if on and dev.type != "cuda":
                raise ValueError(
                    f"capture=True needs a model on a CUDA device, not "
                    f"{dev}")
            if on and not capturable:
                raise ValueError(
                    "capture=True needs collectives a CUDA graph can "
                    "record: this step's communicator is gloo, or its "
                    "gradient reduction follows point-to-point receives "
                    "that read their headers on the host; pass "
                    "capture=False")
            if on:
                metrics = captured_step(state, batch, dev)
            else:
                key, args = signature(state, batch)
                t0 = time.perf_counter()
                metrics = body(state, batch)
                if not prog.known(key):
                    _odevice.watch().record(
                        prog, key, args, time.perf_counter() - t0, "eager")
            state.step += 1
            return state, metrics

        def release() -> None:
            """Free the captured graphs and the gradients that live in
            their memory pools."""
            if graphs:
                torch.cuda.synchronize()
                graphs.clear()
                held.pop("model").zero_grad(set_to_none=True)

        step.graphs = graphs
        step.program = prog
        step.release = release
        return step

    # ------------------------------------------------------------ update
    def update(self, state: TrainState, batch: Any, loss_fn: Callable,
               has_aux: bool = False, stateful: bool = False,
               accum_steps: int = 1, augment: Optional[Callable] = None,
               augment_seed: int = 0, health_check: bool = False,
               spike_factor: float = 10.0, spike_warmup: int = 20,
               spike_ema_beta: float = 0.1, *,
               capture: Optional[bool] = None
               ) -> Tuple[TrainState, dict]:
        """Eager-style API mirroring ``_MultiNodeOptimizer.update``: one
        step built per ``(loss_fn, flags)``, keyed by the function object
        itself (holding a reference: an ``id()`` can be recycled), and
        a warning at the 9th variant (a fresh closure per call builds a
        fresh step each time)."""
        health = (health_check, spike_factor, spike_warmup, spike_ema_beta)
        key = (loss_fn, has_aux, stateful, accum_steps, augment,
               augment_seed, health, capture)
        step = self._step_cache.get(key)
        if step is None:
            step = self._step_cache[key] = self.make_train_step(
                loss_fn, has_aux, stateful, accum_steps=accum_steps,
                augment=augment, augment_seed=augment_seed,
                health_check=health_check, spike_factor=spike_factor,
                spike_warmup=spike_warmup, spike_ema_beta=spike_ema_beta,
                capture=capture)
            if len(self._step_cache) == 9:
                warnings.warn(
                    "9+ distinct train-step variants built on one "
                    "optimizer: loss_fn/augment must be the SAME callable "
                    "across update() calls (build closures like "
                    "random_crop_flip() once, outside the loop)",
                    stacklevel=2)
        return step(state, batch)


def create_multi_node_optimizer(actual_optimizer,
                                communicator: CommunicatorBase,
                                double_buffering: bool = False,
                                grad_reduce: Optional[Callable] = None,
                                grad_compression: Optional[str] = None,
                                ema_decay: Optional[float] = None
                                ) -> MultiNodeOptimizer:
    """Reference anchor: ``chainermn/optimizers.py``
    ``create_multi_node_optimizer(opt, comm, double_buffering=False)``."""
    return MultiNodeOptimizer(actual_optimizer, communicator,
                              double_buffering=double_buffering,
                              grad_reduce=grad_reduce,
                              grad_compression=grad_compression,
                              ema_decay=ema_decay)


def model_parallel_grad_reduce(data_comm, model_comm) -> Callable:
    """The gradient reduction of hybrid data × model training over
    one-stage-per-rank chains (:class:`~chainermn_tpu_torch.links.
    MultiNodeChainList`), for ``create_multi_node_optimizer(...,
    grad_reduce=...)``; the JAX package's ``model_parallel_grad_reduce``.

    The loss is computed alike on every model rank (``F.bcast`` of the
    chain's output, then the loss everywhere), so the broadcast's backward
    sums ``model_size`` equal gradients onto the last stage, and every
    stage's owner holds ``model_size ×`` the true gradient.  Dividing by
    the model size restores it, then the usual mean over the data ranks:
    the same update as the JAX reducer, whose model-axis mean both moves
    each owner's gradient to every shard and cancels the same factor.
    The chain's point-to-point receives read their headers on the host,
    so a step that uses this reducer runs eagerly (``capturable``
    False)."""

    def reduce(model) -> None:
        model_comm.wait_pending()
        with torch.no_grad():
            for p in model.parameters():
                if p.grad is not None:
                    p.grad.div_(model_comm.size)
        data_comm.allreduce_grad(model)

    reduce.capturable = False
    return reduce


# The sharded-state tier builds on the replicated one.
from chainermn_tpu_torch.optimizers.zero import (  # noqa: E402
    ZeroMultiNodeOptimizer,
    ZeroTrainState,
    create_zero_optimizer,
    reshard_zero_state,
    zero_clip_by_global_norm,
)
