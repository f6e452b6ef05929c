"""mfu.serve: serving's model FLOPs over the window (two a matmul
parameter per prompt or output token processed, the head once per token
sampled, attention's two products over the positions attended) over its
seconds and the card's bfloat16 peak."""

from portbench.readings import mfu_pct, of


def read(rec):
    return mfu_pct(rec) if of(rec, "serve") else None
