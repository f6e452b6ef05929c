"""device_idle_pct.train_lm: the share of a traced stretch of LM
training steps in which no operation ran on the card."""

from portbench.readings import idle_pct, of


def read(rec):
    return idle_pct(rec) if of(rec, "train", "gpt2") else None
