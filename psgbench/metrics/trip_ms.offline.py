"""Device ms of the work launched inside the program's ``psg.trip`` spans
(one decode step over a chunk's rows), per trip, in the traced run's span
pass (:mod:`psgbench.spans`); nothing where the program opens no such
span."""

from psgbench.spans import span_pass


def read(ctx):
    sp = span_pass(ctx)
    n = sp["trace"].span_count("psg.trip") if sp else 0
    if not n:
        return None
    return 1e3 * sp["trace"].span_device_s("psg.trip") / n
