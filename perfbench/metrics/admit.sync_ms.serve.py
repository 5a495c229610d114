"""Host time admission spends waiting for the card (every ``sync`` span
under ``serve.admit``: the token check's reads, the first tokens' read),
per request admitted, over the measured steps outside the profiled
window."""

from perfbench.inside import admission_ms


def read(rec):
    return admission_ms(rec, ("sync",), nested=True)
