"""ResNet configurations on the port: the weights' layout (the port's
``ResNet`` parameter names, which follow the Flax tree), the inputs, the
model FLOPs, and the program's training model.
"""

from __future__ import annotations

from typing import Dict, List

from portbench.reference import resnet as ref
from portbench.weights import Spec, sub_seed

reference = ref
#: the end-to-end rate of a training cell.
TRAIN_RATE = "train_images_per_s"


def weight_specs(cfg: dict) -> List[Spec]:
    """Convolutions normal with variance 2 / fan_in, the head normal
    with variance 1 / fan_in, zero biases, unit BN scales."""
    specs: List[Spec] = []
    for name, shape, _, bn in ref.conv_shapes(cfg):
        fan_in = shape[1] * shape[2] * shape[3]
        specs += [(name, shape, "normal", (2.0 / fan_in) ** 0.5),
                  (bn + "scale", (shape[0],), "ones", 0.0),
                  (bn + "bias", (shape[0],), "zeros", 0.0)]
    cin = ref.block_plan(cfg)[-1][2] * cfg["expansion"]
    specs += [("head.weight", (cfg["num_classes"], cin), "normal",
               (1.0 / cin) ** 0.5),
              ("head.bias", (cfg["num_classes"],), "zeros", 0.0)]
    return specs


def bench_views(cfg: dict, named) -> Dict:
    """The port's parameter names are the benchmark's."""
    return dict(named)


def load(cfg: dict, model, weights: Dict) -> None:
    import torch

    named = dict(model.named_parameters())
    if set(named) != set(weights):
        raise ValueError("the port's ResNet parameters "
                         f"{sorted(set(named) ^ set(weights))[:6]} do not "
                         "match the benchmark's layout")
    with torch.no_grad():
        for n, p in named.items():
            p.copy_(weights[n])


def train_model(cfg: dict, traffic: dict, device, comm):
    import torch

    from chainermn_tpu_torch.models import ResNet, resnet_loss

    port = cfg["port"]
    model = ResNet(stage_sizes=cfg["stage_sizes"],
                   num_classes=cfg["num_classes"], width=cfg["width"],
                   dtype=getattr(torch, cfg["compute_dtype"]),
                   axis_name=comm.axis_name, stem=port["stem"],
                   maxpool=port["maxpool"], bn=port["bn"],
                   conv1=port["conv1"], in_channels=cfg["in_channels"],
                   device=device, seed=0)
    return model, resnet_loss(model), {"stateful": True}


def make_batches(cfg: dict, traffic: dict, seed: int, device, torch,
                 rank: int = 0) -> list:
    """``distinct_batches`` batches of NHWC bfloat16 images drawn
    normal(0, 1) and labels uniform over the classes, made on the card
    from the inputs stream of ``seed`` (``rank`` offsets it: each rank
    of a data-parallel job has its own rows)."""
    g = torch.Generator(device=device)
    g.manual_seed(sub_seed(seed, "inputs") + rank)
    B, n, S = traffic["batch"], traffic["distinct_batches"], cfg["image_size"]
    x = torch.randn((n, B, S, S, cfg["in_channels"]), generator=g,
                    device=device, dtype=torch.bfloat16)
    y = torch.randint(0, cfg["num_classes"], (n, B), generator=g,
                      device=device)
    return [(x[i], y[i]) for i in range(n)]


def items_per_step(traffic: dict) -> int:
    return traffic["batch"]


def forward_flops_per_image(cfg: dict) -> float:
    """Two FLOPs per multiply-add of every convolution at its output size
    and of the head."""
    size, total = cfg["image_size"], 0.0
    hw = {"conv_init.weight": -(-size // 2)}
    s = -(-hw["conv_init.weight"] // 2)  # after the max-pool
    for name, (o, i, k, _), stride, _ in ref.conv_shapes(cfg):
        if name == "conv_init.weight":
            out = hw[name]
        elif name.endswith("conv1.weight"):
            # The block's strided convolution: it and everything after
            # it in the block (the projection too) run at the new size.
            s = out = -(-s // stride)
        else:
            out = s
        total += 2.0 * o * i * k * k * out * out
    cin = ref.block_plan(cfg)[-1][2] * cfg["expansion"]
    return total + 2.0 * cin * cfg["num_classes"]


def train_flops_per_step(cfg: dict, traffic: dict) -> float:
    """Forward and backward model FLOPs of one step's images: the
    backward twice the forward, less the stem's input gradient, which
    no one needs."""
    size = cfg["image_size"]
    stem_out = -(-size // 2)
    stem = 2.0 * cfg["width"] * cfg["in_channels"] * 49 * stem_out ** 2
    return traffic["batch"] * (3 * forward_flops_per_image(cfg) - stem)
