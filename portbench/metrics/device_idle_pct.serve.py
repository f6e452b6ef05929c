"""device_idle_pct.serve: the share of a traced stretch of serving ticks
in which no operation ran on the card."""

from portbench.readings import idle_pct, of


def read(rec):
    return idle_pct(rec) if of(rec, "serve") else None
