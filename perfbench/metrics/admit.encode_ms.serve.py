"""Host time of the log-mel and the encoder in admission (the program's
``mel`` and ``encode`` spans under ``serve.admit``, less their ``sync``
children), per request admitted, over the measured steps outside the
profiled window."""

from perfbench.inside import admission_ms


def read(rec):
    return admission_ms(rec, ("mel", "encode"))
