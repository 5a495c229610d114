"""Share of the traced window in which no operation ran on the card, in
percent."""

from perfbench.metrics.common import idle_share


def read(rec):
    return idle_share(rec, "longform")
