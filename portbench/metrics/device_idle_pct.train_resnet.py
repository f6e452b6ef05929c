"""device_idle_pct.train_resnet: the share of a traced stretch of ResNet
training steps in which no operation ran on the card."""

from portbench.readings import idle_pct, of


def read(rec):
    return idle_pct(rec) if of(rec, "train", "resnet") else None
