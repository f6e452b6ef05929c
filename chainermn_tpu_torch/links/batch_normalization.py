"""Cross-rank (sync) batch normalization: the port of
``chainermn_tpu/links/batch_normalization.py``.

Reference anchor: ``chainermn/links/batch_normalization.py`` --
``MultiNodeBatchNormalization``: the batch mean and mean of squares are
all-reduced across the communicator in the forward, with the matching
all-reduce in the backward.

The JAX package takes ``lax.pmean`` of the moments inside its SPMD step
and lets AD transpose it.  Here one process drives one card, so the
normalization is a :class:`torch.autograd.Function` whose forward
all-reduces the per-channel moments and whose backward all-reduces their
cotangents (the transpose of a mean over ranks is a mean over ranks),
through the process group the caller passes as ``axis_name`` (the
communicator's ``axis_name``; None normalizes over the local batch only).
The forward saves the input in its own dtype and the per-channel
statistics only; the fp32 intermediates are recomputed in the backward.

Layout: channels on dim 1 (``(N, C)`` or ``(N, C, H, W)``, any memory
format), PyTorch's convention; the statistics reduce over every other dim.
The formula is the JAX package's, not ``nn.BatchNorm2d``'s: fp32 moments,
``var = E[x²] - mean²`` (biased), ``y = (x - mean) · rsqrt(var + eps) ·
scale + bias`` cast back to the input dtype, running statistics updated
``m · running + (1 - m) · batch`` with ``m = 0.9`` and the biased global
variance.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
import torch.nn as nn

__all__ = ["MultiNodeBatchNormalization", "sync_batch_norm"]


def _dims(x):
    return [d for d in range(x.dim()) if d != 1]


def _bcast(v, x):
    """A per-channel vector shaped to broadcast over ``x`` (channels on
    dim 1)."""
    return v.view(1, -1, *([1] * (x.dim() - 2)))


def all_reduce_mean(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` averaged over the ranks of ``group`` (a new tensor; ``t`` as
    it is when ``group`` is None)."""
    if group is None:
        return t
    out = t.clone()
    dist.all_reduce(out, group=group)
    return out / dist.get_world_size(group)


class SyncBatchNormFunction(torch.autograd.Function):
    """Training-mode normalization over the local batch and the ranks of
    ``group``; returns ``(y, mean, var)`` with ``mean``/``var`` the global
    fp32 moments (not differentiated)."""

    @staticmethod
    def forward(ctx, x, scale, bias, group, eps):
        # Normalized in place below, so a copy even when x is fp32.
        xf = x.to(torch.float32, copy=True)
        dims = _dims(x)
        moments = torch.stack([xf.mean(dim=dims), xf.square().mean(dim=dims)])
        moments = all_reduce_mean(moments, group)
        mean, mean_sq = moments[0], moments[1]
        var = mean_sq - mean.square()
        inv = torch.rsqrt(var + eps)
        y = xf.sub_(_bcast(mean, x)).mul_(_bcast(inv, x)) \
            .mul_(_bcast(scale.float(), x)).add_(_bcast(bias.float(), x))
        ctx.save_for_backward(x, scale, mean, inv)
        ctx.group = group
        ctx.mark_non_differentiable(mean, var)
        return y.to(x.dtype), mean, var

    @staticmethod
    def backward(ctx, gy, _gmean, _gvar):
        x, scale, mean, inv = ctx.saved_tensors
        n = x.numel() // x.shape[1]
        dims = _dims(x)
        xc = x.to(torch.float32, copy=True).sub_(_bcast(mean, x))
        gy = gy.to(torch.float32, copy=True)
        s1 = gy.sum(dim=dims)            # Σ g
        s2 = (gy * xc).sum(dim=dims)     # Σ g (x - mean)
        scale = scale.float()
        dscale = s2 * inv
        dbias = s1
        # Through mean and var = E[x²] - mean² to the two moments, whose
        # cotangents go back through the transpose of the mean over ranks.
        dvar = scale * s2 * (-0.5) * inv.pow(3)
        dmean = -scale * inv * s1 - 2.0 * mean * dvar
        dmom = all_reduce_mean(torch.stack([dmean, dvar]), ctx.group)
        # x reaches the moments as mean = Σx / n and E[x²] = Σx² / n:
        # dx = g·scale·inv + dmean / n + 2 x dvar / n, with x = xc + mean.
        dmean_g, dvar_g = dmom[0], dmom[1]
        dx = (gy.mul_(_bcast(scale * inv, x))
              .add_(_bcast((dmean_g + 2.0 * mean * dvar_g) / n, x))
              .add_(xc.mul_(_bcast(2.0 * dvar_g / n, x))))
        return dx.to(x.dtype), dscale, dbias, None, None


def sync_batch_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                    axis_name=None, eps: float = 1e-5) -> torch.Tensor:
    """Functional sync-BN over the batch (every dim but 1) and the ranks
    of the process group ``axis_name``.  Moments in fp32; the output keeps
    the input dtype."""
    return SyncBatchNormFunction.apply(x, scale, bias, axis_name, eps)[0]


class MultiNodeBatchNormalization(nn.Module):
    """Batch normalization whose training-mode statistics span the ranks
    of ``axis_name`` (a ``torch.distributed`` process group, e.g. the
    communicator's ``axis_name``; None: the local batch).

    Parameters ``scale`` and ``bias``; buffers ``mean`` and ``var`` (the
    JAX package's ``batch_stats`` collection), updated in place from the
    *global* moments, so every rank keeps identical statistics and eval
    mode matches a single process trained on the global batch.
    ``use_running_average`` (or ``train=False``) normalizes with the
    buffers: a per-channel affine, differentiable in ``scale`` and
    ``bias``."""

    def __init__(self, features: int, axis_name=None, momentum: float = 0.9,
                 epsilon: float = 1e-5, use_running_average: bool = False,
                 device=None):
        super().__init__()
        self.features = features
        self.axis_name = axis_name
        self.momentum = momentum
        self.epsilon = epsilon
        self.use_running_average = use_running_average
        fk = dict(device=device, dtype=torch.float32)
        self.scale = nn.Parameter(torch.ones(features, **fk))
        self.bias = nn.Parameter(torch.zeros(features, **fk))
        self.register_buffer("mean", torch.zeros(features, **fk))
        self.register_buffer("var", torch.ones(features, **fk))

    def forward(self, x: torch.Tensor,
                use_running_average: Optional[bool] = None) -> torch.Tensor:
        use_ra = (self.use_running_average if use_running_average is None
                  else use_running_average)
        if use_ra:
            inv = torch.rsqrt(self.var + self.epsilon)
            y = ((x.float() - _bcast(self.mean, x)) * _bcast(inv, x)
                 * _bcast(self.scale, x) + _bcast(self.bias, x))
            return y.to(x.dtype)
        y, mean, var = SyncBatchNormFunction.apply(
            x, self.scale, self.bias, self.axis_name, self.epsilon)
        with torch.no_grad():
            m = self.momentum
            self.mean.mul_(m).add_((1 - m) * mean)
            self.var.mul_(m).add_((1 - m) * var)
        return y

    def extra_repr(self) -> str:
        return (f"{self.features}, momentum={self.momentum}, "
                f"eps={self.epsilon}, sync={self.axis_name is not None}")
