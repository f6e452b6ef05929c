"""GPT-2 configurations on the port: the weights' layout and how it maps
onto the port's ``TransformerLM``, the inputs, the model FLOPs, and the
program's training model and serving engine.

The benchmark's layout keeps ``q``, ``k`` and ``v`` apart; the port fuses
them into one ``qkv`` projection whose output rows are ``[q; k; v]``.
"""

from __future__ import annotations

from typing import Dict, List

from portbench.reference import gpt2 as ref
from portbench.weights import Spec, sub_seed

reference = ref
#: the end-to-end rate of a training cell.
TRAIN_RATE = "train_tokens_per_s"


def weight_specs(cfg: dict) -> List[Spec]:
    """GPT-2's initializer: normal with ``initializer_range`` (the
    residual projections divided by ``sqrt(2 n_layer)``), zero biases,
    unit LayerNorm scales."""
    d = ref.dims(cfg)
    std = cfg["initializer_range"]
    proj = std / (2 * d["L"]) ** 0.5
    D, F, V = d["D"], d["F"], d["V"]
    specs: List[Spec] = [("wte", (V, D), "normal", std),
                         ("wpe", (d["P"], D), "normal", std)]
    for i in range(d["L"]):
        p = f"h.{i}."
        specs += [(p + "ln_1.weight", (D,), "ones", 0.0),
                  (p + "ln_1.bias", (D,), "zeros", 0.0)]
        for n in ("q", "k", "v"):
            specs += [(p + f"attn.{n}.weight", (D, D), "normal", std),
                      (p + f"attn.{n}.bias", (D,), "zeros", 0.0)]
        specs += [(p + "attn.proj.weight", (D, D), "normal", proj),
                  (p + "attn.proj.bias", (D,), "zeros", 0.0),
                  (p + "ln_2.weight", (D,), "ones", 0.0),
                  (p + "ln_2.bias", (D,), "zeros", 0.0),
                  (p + "mlp.fc.weight", (F, D), "normal", std),
                  (p + "mlp.fc.bias", (F,), "zeros", 0.0),
                  (p + "mlp.proj.weight", (D, F), "normal", proj),
                  (p + "mlp.proj.bias", (D,), "zeros", 0.0)]
    specs += [("ln_f.weight", (D,), "ones", 0.0),
              ("ln_f.bias", (D,), "zeros", 0.0),
              ("lm_head.weight", (V, D), "normal", std),
              ("lm_head.bias", (V,), "zeros", 0.0)]
    return specs


def _pieces(cfg: dict) -> Dict[str, List[str]]:
    """The port's parameter name -> the benchmark's weights it holds, in
    row order."""
    L = ref.dims(cfg)["L"]
    m = {"embed.weight": ["wte"], "pos": ["wpe"]}
    for i in range(L):
        p, b = f"h.{i}.", f"blocks.{i}."
        for s in ("weight", "bias"):
            m[b + f"ln1.{s}"] = [p + f"ln_1.{s}"]
            m[b + f"qkv.{s}"] = [p + f"attn.{n}.{s}" for n in "qkv"]
            m[b + f"proj.{s}"] = [p + f"attn.proj.{s}"]
            m[b + f"ln2.{s}"] = [p + f"ln_2.{s}"]
            m[b + f"ff1.{s}"] = [p + f"mlp.fc.{s}"]
            m[b + f"ff2.{s}"] = [p + f"mlp.proj.{s}"]
    for s in ("weight", "bias"):
        m[f"ln_f.{s}"] = [f"ln_f.{s}"]
        m[f"lm_head.{s}"] = [f"lm_head.{s}"]
    return m


def bench_views(cfg: dict, named) -> Dict:
    """``{benchmark weight name: view}`` of tensors laid out as the port's
    parameters (the parameters themselves, their gradients or their
    optimizer state), by the port's parameter name."""
    out = {}
    for pname, t in named.items():
        names = _pieces(cfg)[pname]
        rows = t.shape[0] // len(names)
        for j, n in enumerate(names):
            out[n] = t[j * rows:(j + 1) * rows] if len(names) > 1 else t
    return out


def load(cfg: dict, model, weights: Dict) -> None:
    """Copy the benchmark's weights into the port's model, every
    parameter of which they must cover exactly."""
    import torch

    pieces = _pieces(cfg)
    named = dict(model.named_parameters())
    if set(named) != set(pieces):
        raise ValueError("the port's TransformerLM parameters "
                         f"{sorted(set(named) ^ set(pieces))[:6]} do not "
                         "match the benchmark's layout")
    with torch.no_grad():
        for pname, p in named.items():
            src = [weights[n] for n in pieces[pname]]
            p.copy_(src[0] if len(src) == 1 else torch.cat(src, 0))


def _lm(cfg: dict, device, **kw):
    import torch

    from chainermn_tpu_torch.models import TransformerLM

    d = ref.dims(cfg)
    port = cfg["port"]
    return TransformerLM(
        vocab=d["V"], n_layers=d["L"], d_model=d["D"], n_heads=d["H"],
        d_ff=d["F"], max_len=d["P"], dtype=getattr(torch, cfg["compute_dtype"]),
        param_dtype=getattr(torch, cfg["param_dtype"]),
        pos_enc=port["pos_enc"], device=device, seed=0, **kw)


# ----------------------------------------------------------------- train
def train_model(cfg: dict, traffic: dict, device, comm):
    """The port's training model and its loss: ``(model, loss_fn,
    flags)`` for ``make_train_step(loss_fn, **flags)``."""
    from chainermn_tpu_torch.models import lm_loss

    port = cfg["port"]
    model = _lm(cfg, device, attention=port["train_attention"],
                remat=port["remat"])
    return model, lm_loss(model), {"has_aux": True}


def make_batches(cfg: dict, traffic: dict, seed: int, device, torch,
                 rank: int = 0) -> list:
    """``distinct_batches`` batches of ``(tokens, targets)``, each ``batch``
    rows of ``seq_len`` ids uniform over the vocabulary, made on the
    card from the inputs stream of ``seed``."""
    g = torch.Generator(device=device)
    g.manual_seed(sub_seed(seed, "inputs") + rank)
    B, T, n = traffic["batch"], traffic["seq_len"], traffic["distinct_batches"]
    ids = torch.randint(0, cfg["vocab_size"], (n, B, T + 1), generator=g,
                        device=device)
    return [(ids[i, :, :-1], ids[i, :, 1:]) for i in range(n)]


def items_per_step(traffic: dict) -> int:
    return traffic["batch"] * traffic["seq_len"]


def matmul_params(cfg: dict) -> int:
    """Parameters that enter a matrix product (every block's four
    attention and two MLP matrices, and the head)."""
    d = ref.dims(cfg)
    return d["L"] * (4 * d["D"] ** 2 + 2 * d["D"] * d["F"]) + d["V"] * d["D"]


def train_flops_per_step(cfg: dict, traffic: dict) -> float:
    """Model FLOPs of one training step: 6 × matmul parameters × tokens,
    plus causal attention's two products, forward (4·Dh a pair and head)
    and backward (twice that), with no recompute."""
    d = ref.dims(cfg)
    B, T = traffic["batch"], traffic["seq_len"]
    pairs = T * (T + 1) // 2
    attn = 3 * 4 * d["Dh"] * d["H"] * B * pairs * d["L"]
    return 6.0 * matmul_params(cfg) * B * T + attn


def flash_bound_s(cfg: dict, traffic: dict) -> float:
    """Least seconds of one step's attention on the card: the forward and
    the two backward kernels' bounds at the step's shapes, every layer."""
    from portbench.roofline import flash_bounds

    d = ref.dims(cfg)
    b = flash_bounds(traffic["batch"], traffic["seq_len"], d["H"], d["Dh"])
    return d["L"] * sum(t for t, _ in b.values())


# ----------------------------------------------------------------- serve
def serving_model(cfg: dict, device):
    return _lm(cfg, device, decode_attention=cfg["port"]["decode_attention"])

