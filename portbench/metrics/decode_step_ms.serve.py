"""decode_step_ms.serve: the mean of the scheduler's serve.decode_ms over
the window: clean decode steps, host clock around a step that ends in
its tokens' readback."""

from portbench.readings import of


def read(rec):
    if not of(rec, "serve"):
        return None
    total, count = rec["hist_ms"]["serve.decode_ms"]
    return total / count if count else None
