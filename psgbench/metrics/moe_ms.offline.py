"""Device ms of the work launched inside the program's ``psg.moe`` spans
(each expert layer of the LLM: router, routed and shared experts, the
weighted combine), per image, in the traced run's span pass
(:mod:`psgbench.spans`); nothing where the program opens no such span."""

from psgbench.spans import per_image


def read(ctx):
    return per_image(ctx, "psg.moe", lambda tr: 1e3 * tr.span_device_s("psg.moe"))
