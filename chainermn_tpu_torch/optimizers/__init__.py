"""The data-parallel optimizer of the port (``chainermn_tpu/optimizers``
``MultiNodeOptimizer``, ``create_multi_node_optimizer``).

The reference's hot loop (SURVEY.md §3.2): forward and backward on each
rank's batch, ``communicator.allreduce_grad``, then the inner optimizer's
update.  The JAX package compiles that loop into one SPMD program; here
it runs eagerly, one process per card, with the gradient all-reduce as
one flat-bucket collective between the backward and the update.

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
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
import torch.nn as nn

from chainermn_tpu_torch.comm.base import CommunicatorBase

__all__ = ["MultiNodeOptimizer", "TrainState", "adamw",
           "create_multi_node_optimizer", "sgd"]


def sgd(learning_rate: float, momentum: Optional[float] = None,
        nesterov: bool = False):
    """``optax.sgd`` as a torch optimizer factory: ``trace = g + momentum
    · trace``, ``p -= lr · trace`` (``nesterov``: ``p -= lr · (g +
    momentum · trace)``), no dampening, no weight decay -- which is
    ``torch.optim.SGD`` with ``dampening=0``; plain SGD when ``momentum``
    is None."""
    return functools.partial(torch.optim.SGD, lr=learning_rate,
                             momentum=momentum or 0.0, dampening=0.0,
                             nesterov=nesterov, weight_decay=0.0)


def adamw(learning_rate: float, b1: float = 0.9, b2: float = 0.999,
          eps: float = 1e-8, weight_decay: float = 1e-4):
    """``optax.adamw`` as a torch optimizer factory, with optax's defaults
    (its weight decay is 1e-4 where torch's AdamW defaults to 1e-2).  The
    update is the same: decay and the bias-corrected Adam step both from
    the old parameters, on every parameter (optax's mask is None)."""
    return functools.partial(torch.optim.AdamW, lr=learning_rate,
                             betas=(b1, b2), eps=eps,
                             weight_decay=weight_decay)


@dataclass
class TrainState:
    """The training state carried across steps: the step count, the model
    (updated in place) and its torch optimizer."""

    step: int
    model: nn.Module
    optimizer: torch.optim.Optimizer

    @property
    def params(self) -> Dict[str, torch.Tensor]:
        return dict(self.model.named_parameters())

    @property
    def model_state(self) -> Dict[str, torch.Tensor]:
        """The model's buffers (e.g. sync-BN running statistics)."""
        return dict(self.model.named_buffers())


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


class MultiNodeOptimizer:
    """Wraps a torch optimizer (or a factory ``params -> optimizer`` such
    as :func:`adamw`) with the cross-rank gradient mean."""

    def __init__(self, actual_optimizer, communicator: CommunicatorBase,
                 double_buffering: bool = False,
                 grad_reduce: Optional[Callable] = None,
                 grad_compression: Optional[str] = None,
                 ema_decay: Optional[float] = None):
        for flag, what, item in (
                (double_buffering, "double_buffering", "6"),
                (grad_reduce is not None, "grad_reduce", "8"),
                (grad_compression is not None, "grad_compression", "6"),
                (ema_decay is not None, "ema_decay", "6")):
            if flag:
                raise NotImplementedError(
                    f"{what} is not ported yet (ROADMAP Queue 1 item "
                    f"{item})")
        self.actual = actual_optimizer
        self.comm = communicator

    def init(self, model: nn.Module) -> TrainState:
        """Broadcast rank 0's parameters to every rank (so all replicas
        start equal) and build the torch optimizer over them."""
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
        return TrainState(step=0, model=model, optimizer=opt)

    def make_train_step(self, loss_fn: Callable, has_aux: bool = False,
                        stateful: bool = False, accum_steps: int = 1,
                        augment: Optional[Callable] = None,
                        health_check: bool = False) -> Callable:
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
        ``metrics["loss"]`` and the aux scalars are averaged over ranks."""
        for flag, what, item in ((augment is not None, "augment", "7"),
                                 (health_check, "health_check", "12")):
            if flag:
                raise NotImplementedError(
                    f"{what} is not ported yet (ROADMAP Queue 1 item "
                    f"{item})")
        if accum_steps < 1:
            raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
        comm = self.comm

        def step(state: TrainState, batch: Any):
            model, opt = state.model, state.optimizer
            opt.zero_grad(set_to_none=True)
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
            comm.allreduce_grad(model)
            opt.step()
            metrics = {"loss": comm.allreduce(loss_sum / accum_steps,
                                              op="mean")}
            for k, v in aux_sum.items():
                metrics[k] = comm.allreduce(v / accum_steps, op="mean")
            state.step += 1
            return state, metrics

        return step


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
