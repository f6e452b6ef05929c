"""mfu.train_lm: LM training's model FLOPs (6 x matmul parameters x
tokens, plus causal attention's two products forward and backward, no
recompute) over the window, the card's bfloat16 peak and the chips."""

from portbench.readings import mfu_pct, of


def read(rec):
    return mfu_pct(rec) if of(rec, "train", "gpt2") else None
