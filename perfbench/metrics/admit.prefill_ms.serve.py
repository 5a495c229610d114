"""Host time of the cross K/V and the prompt prefill in admission (the
program's ``cross_kv`` and ``prefill`` spans under ``serve.admit``, less
their ``sync`` children), per request admitted, over the measured steps
outside the profiled window."""

from perfbench.inside import admission_ms


def read(rec):
    return admission_ms(rec, ("cross_kv", "prefill"))
