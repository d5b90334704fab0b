"""Device ms of the work launched inside the program's ``psg.prefill``
spans (the LLM's prefill forward, the KV cache's allocation and fill, the
first pick), per image, in the traced run's span pass
(:mod:`psgbench.spans`); nothing where the program opens no such span."""

from psgbench.spans import per_image


def read(ctx):
    return per_image(ctx, "psg.prefill", lambda tr: 1e3 * tr.span_device_s("psg.prefill"))
