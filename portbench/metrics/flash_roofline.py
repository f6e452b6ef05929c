"""flash_roofline: the least seconds of the traced steps' attention (the
forward and both backward kernels' bounds at the step's shapes, every
layer, once a step) over the device seconds of the flash-attention
kernels K1-K3 in the trace, whatever they ran (remat's second forward
included)."""

from portbench.readings import of, roofline_pct

SYMBOLS = ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq")


def read(rec):
    if not of(rec, "train"):
        return None
    return roofline_pct(rec, "flash_bound_s", SYMBOLS)
