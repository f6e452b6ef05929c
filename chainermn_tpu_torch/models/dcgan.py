"""DCGAN generator and discriminator and the two-optimizer data-parallel
GAN step: the port of ``chainermn_tpu/models/dcgan.py``.

Reference anchor: ``examples/dcgan/`` upstream (``net.py``,
``updater.py``): each iteration one shared forward (the fake batch through
the discriminator beside the real one), then the discriminator's and the
generator's losses each back-propagated into its own multi-node optimizer.

Here each data rank runs the step on its shard of the batch: both losses
are taken at the current parameters from one generator forward, both
gradient sets are mean-reduced over the data ranks
(``comm.allreduce_grad``), and both optimizers step.  The noise ``z``
rides in the batch, as in the JAX package, so each rank draws its own
samples.  The convolutions go to cuDNN.

Layouts: images NCHW inside (the public input and output are NHWC, as the
JAX package's); ``ConvTranspose`` is Flax's (a dilated-input convolution
with the kernel unflipped), so the bridge flips Flax kernels into torch's
``conv_transpose2d`` weights
(:func:`~chainermn_tpu_torch.utils.dcgan_params_from_flax`).  LayerNorm
normalizes over the channels of each position (Flax's last axis), eps
1e-6.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch
import torch.nn as nn
import torch.nn.functional as F

from chainermn_tpu_torch.utils.device import resolve_device

__all__ = ["Discriminator", "GanState", "Generator", "gan_init",
           "make_gan_train_step"]

LN_EPS = 1e-6


class _ChannelNorm(nn.Module):
    """Flax ``LayerNorm`` over the channel axis of NCHW activations."""

    def __init__(self, c: int, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c, device=device))
        self.bias = nn.Parameter(torch.zeros(c, device=device))

    def forward(self, h):
        mu = h.mean(dim=1, keepdim=True)
        var = (h * h).mean(dim=1, keepdim=True) - mu * mu
        y = (h - mu) * torch.rsqrt(var.clamp_min(0.0) + LN_EPS)
        return y * self.weight[:, None, None] + self.bias[:, None, None]


def _init(module: nn.Module, seed: int) -> None:
    """Flax-default-like: LeCun-normal kernels (variance 1/fan_in), zero
    biases, unit LayerNorm scales."""
    g = torch.Generator(device=next(module.parameters()).device)
    g.manual_seed(int(seed))
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (nn.Linear, nn.Conv2d, nn.ConvTranspose2d)):
                w = m.weight
                if isinstance(m, nn.Linear):
                    fan_in = w.shape[1]
                elif isinstance(m, nn.Conv2d):
                    fan_in = w[0].numel()
                else:  # (in, out, kh, kw): Flax's fan-in is kh*kw*in
                    fan_in = w.shape[0] * w.shape[2] * w.shape[3]
                w.normal_(0.0, fan_in ** -0.5, generator=g)
                m.bias.zero_()


class Generator(nn.Module):
    """z ``(B, nz)`` -> image ``(B, 32, 32, out_ch)`` (NHWC, tanh): a
    projection to ``bottom x bottom x 4·ch``, then three stride-2
    transposed convolutions (4 -> 8 -> 16 -> 32)."""

    def __init__(self, ch: int = 64, out_ch: int = 1, bottom: int = 4,
                 nz: int = 64, device=None, seed: int = 0):
        super().__init__()
        dev = resolve_device(device, "Generator")
        self.ch, self.bottom = ch, bottom
        self.project = nn.Linear(nz, bottom * bottom * ch * 4, device=dev)
        self.ln0 = _ChannelNorm(ch * 4, dev)
        self.up0 = nn.ConvTranspose2d(ch * 4, ch * 2, 4, 2, 1, device=dev)
        self.ln1 = _ChannelNorm(ch * 2, dev)
        self.up1 = nn.ConvTranspose2d(ch * 2, ch, 4, 2, 1, device=dev)
        self.ln2 = _ChannelNorm(ch, dev)
        self.to_img = nn.ConvTranspose2d(ch, out_ch, 4, 2, 1, device=dev)
        _init(self, seed)

    @property
    def device(self) -> torch.device:
        return self.project.weight.device

    def forward(self, z):
        b = z.shape[0]
        h = self.project(z).view(b, self.bottom, self.bottom, self.ch * 4)
        h = F.relu(self.ln0(h.permute(0, 3, 1, 2)))
        h = F.relu(self.ln1(self.up0(h)))
        h = F.relu(self.ln2(self.up1(h)))
        return torch.tanh(self.to_img(h)).permute(0, 2, 3, 1)


class Discriminator(nn.Module):
    """image ``(B, 32, 32, C)`` NHWC -> real/fake logit ``(B,)``: three
    stride-2 convolutions (32 -> 16 -> 8 -> 4), LayerNorm after the last
    two (sync-BN on a half-fake batch would leak the labels), leaky ReLU
    0.2, a dense head over the NHWC-flattened features."""

    def __init__(self, ch: int = 64, in_ch: int = 1, size: int = 32,
                 device=None, seed: int = 0):
        super().__init__()
        dev = resolve_device(device, "Discriminator")
        self.down0 = nn.Conv2d(in_ch, ch, 4, 2, 1, device=dev)
        self.down1 = nn.Conv2d(ch, ch * 2, 4, 2, 1, device=dev)
        self.ln0 = _ChannelNorm(ch * 2, dev)
        self.down2 = nn.Conv2d(ch * 2, ch * 4, 4, 2, 1, device=dev)
        self.ln1 = _ChannelNorm(ch * 4, dev)
        self.head = nn.Linear((size // 8) ** 2 * ch * 4, 1, device=dev)
        _init(self, seed)

    @property
    def device(self) -> torch.device:
        return self.head.weight.device

    def forward(self, x):
        h = F.leaky_relu(self.down0(x.permute(0, 3, 1, 2)), 0.2)
        h = F.leaky_relu(self.ln0(self.down1(h)), 0.2)
        h = F.leaky_relu(self.ln1(self.down2(h)), 0.2)
        return self.head(h.permute(0, 2, 3, 1).reshape(h.shape[0], -1))[:, 0]


@dataclass
class GanState:
    """The two-player training state: the step, both players (their
    parameters updated in place) and their optimizers."""

    step: int
    gen: Generator
    disc: Discriminator
    g_opt: torch.optim.Optimizer
    d_opt: torch.optim.Optimizer


def _bce_logits(logits: torch.Tensor, target: float) -> torch.Tensor:
    """Mean sigmoid cross-entropy against a constant label (the softplus
    form of the JAX package)."""
    t = torch.full_like(logits, target)
    return (torch.clamp_min(logits, 0.0) - logits * t
            + torch.log1p(torch.exp(-logits.abs()))).mean()


def gan_init(gen: Generator, disc: Discriminator, g_tx: Callable,
             d_tx: Callable, comm) -> GanState:
    """Both players replicated from rank 0 (``comm.bcast_data``) and their
    optimizers built (``g_tx``/``d_tx``: optimizer factories such as
    ``adamw(...)`` or ``sgd(...)``)."""
    comm.bcast_data(gen)
    comm.bcast_data(disc)
    return GanState(step=0, gen=gen, disc=disc,
                    g_opt=g_tx(gen.parameters()),
                    d_opt=d_tx(disc.parameters()))


def make_gan_train_step(comm) -> Callable:
    """``step(state, (real, z)) -> (state, metrics)`` on this rank's
    shard of the batch (``real`` NHWC images, ``z`` noise): both losses at
    the current parameters (the discriminator's on the real and the
    detached fake batch, the generator's non-saturating one through the
    discriminator), both gradient sets mean-reduced over the ranks, both
    optimizers stepped together — the reference updater's simultaneous
    update.  ``metrics``: ``loss_dis``, ``loss_gen``, averaged over the
    ranks.  Runs eagerly."""

    def step(state: GanState, batch):
        gen, disc = state.gen, state.disc
        dev = gen.device
        real, z = (torch.as_tensor(t, device=dev) for t in batch)
        fake = gen(z)
        d_loss = _bce_logits(disc(real), 1.0) + \
            _bce_logits(disc(fake.detach()), 0.0)
        g_loss = _bce_logits(disc(fake), 1.0)
        d_params, g_params = list(disc.parameters()), list(gen.parameters())
        d_grads = torch.autograd.grad(d_loss, d_params)
        g_grads = torch.autograd.grad(g_loss, g_params)
        for ps, gs in ((d_params, d_grads), (g_params, g_grads)):
            for p, g in zip(ps, gs):
                p.grad = g
        comm.allreduce_grad(disc)
        comm.allreduce_grad(gen)
        state.d_opt.step()
        state.g_opt.step()
        state.step += 1
        return state, {"loss_dis": comm.allreduce(d_loss.detach(), "mean"),
                       "loss_gen": comm.allreduce(g_loss.detach(), "mean")}

    return step
