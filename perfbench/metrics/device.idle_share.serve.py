"""Share of the traced window in which no operation ran on the card (the
union of the device operations' intervals), in percent."""

from perfbench.metrics.common import idle_share


def read(rec):
    return idle_share(rec, "serve")
