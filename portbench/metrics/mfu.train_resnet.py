"""mfu.train_resnet: ResNet training's model FLOPs (forward and backward
of every convolution and the head, counted from the layer shapes, no
recompute) over the window, the card's bfloat16 peak and the chips."""

from portbench.readings import mfu_pct, of


def read(rec):
    return mfu_pct(rec) if of(rec, "train", "resnet") else None
