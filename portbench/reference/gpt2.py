"""Plain GPT-2 (Radford et al. 2019) in float32: the reference that the
GPT-2 cells' outputs are judged by.

Pre-norm decoder blocks: ``h += proj(attn(ln_1(h)))``, ``h += mlp(ln_2(h))``
with the tanh approximation of GELU (``gelu_new``), learned positions, a
final LayerNorm and an output head.  The head has its own weight and a
bias, and LayerNorm takes the configuration's epsilon: the departures the
configuration file names.  Weights are a ``{name: tensor}`` dict in the
benchmark's own layout (``(out, in)`` matrices, ``q``, ``k`` and ``v``
apart).  Imports nothing but PyTorch.

``rnd`` (None: exact) rounds wherever the program's compute dtype does:
the token and position rows and their sum, every residual sum, every
LayerNorm's output, the operands and the result of every matrix product
in the blocks, the attention probabilities before their product with
``v``, and the head's input (the head itself runs in float32, as in the
program).  The control passes a rounding to a lower precision.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F

Rnd = Optional[Callable[[torch.Tensor], torch.Tensor]]


def dims(cfg: dict) -> dict:
    D = cfg["n_embd"]
    return dict(L=cfg["n_layer"], D=D, H=cfg["n_head"], Dh=D // cfg["n_head"],
                F=cfg.get("n_inner") or 4 * D, V=cfg["vocab_size"],
                P=cfg["n_positions"], eps=cfg["layer_norm_epsilon"])


def _id(x):
    return x


def _lin(x, w, b, rnd):
    return rnd(rnd(x) @ rnd(w).t() + rnd(b))


def forward(w: Dict[str, torch.Tensor], cfg: dict, tokens: torch.Tensor,
            rnd: Rnd = None) -> torch.Tensor:
    """``(B, T)`` token ids -> ``(B, T, V)`` float32 logits."""
    d = dims(cfg)
    rnd = rnd or _id
    B, T = tokens.shape
    H, Dh, eps = d["H"], d["Dh"], d["eps"]
    h = rnd(rnd(w["wte"][tokens]) + rnd(w["wpe"][:T][None]))
    causal = torch.ones(T, T, dtype=torch.bool, device=tokens.device).tril()
    for i in range(d["L"]):
        p = f"h.{i}."
        x = rnd(F.layer_norm(h, (d["D"],), w[p + "ln_1.weight"],
                             w[p + "ln_1.bias"], eps))
        q, k, v = (_lin(x, w[p + f"attn.{n}.weight"], w[p + f"attn.{n}.bias"],
                        rnd).view(B, T, H, Dh).transpose(1, 2)
                   for n in ("q", "k", "v"))
        s = (q @ k.transpose(-1, -2)) / math.sqrt(Dh)
        s = s.masked_fill(~causal, float("-inf"))
        a = rnd(rnd(torch.softmax(s, dim=-1)) @ v)
        a = a.transpose(1, 2).reshape(B, T, d["D"])
        h = rnd(h + _lin(a, w[p + "attn.proj.weight"],
                         w[p + "attn.proj.bias"], rnd))
        x = rnd(F.layer_norm(h, (d["D"],), w[p + "ln_2.weight"],
                             w[p + "ln_2.bias"], eps))
        x = rnd(F.gelu(_lin(x, w[p + "mlp.fc.weight"], w[p + "mlp.fc.bias"],
                            rnd), approximate="tanh"))
        h = rnd(h + _lin(x, w[p + "mlp.proj.weight"],
                         w[p + "mlp.proj.bias"], rnd))
    h = rnd(F.layer_norm(h, (d["D"],), w["ln_f.weight"], w["ln_f.bias"],
                         eps))
    return h @ w["lm_head.weight"].t() + w["lm_head.bias"]


def loss_and_grads(w: Dict[str, torch.Tensor], cfg: dict, batch,
                   rows: int, rnd: Rnd = None):
    """The token-mean cross-entropy of ``batch = (tokens, targets)`` and
    its gradient in every weight, computed ``rows`` sequences at a time
    (the mean is over the whole batch).  ``(loss, {name: grad})``."""
    tokens, targets = batch
    n = targets.numel()
    params = {k: v.detach().requires_grad_(True) for k, v in w.items()}
    total = torch.zeros((), dtype=torch.float64, device=tokens.device)
    for lo in range(0, tokens.shape[0], rows):
        logits = forward(params, cfg, tokens[lo:lo + rows], rnd)
        ce = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                             targets[lo:lo + rows].reshape(-1),
                             reduction="sum")
        (ce / n).backward()
        total += ce.detach().double()
        del logits, ce
    return (total / n).float(), {k: p.grad for k, p in params.items()}
