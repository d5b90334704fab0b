"""Device ms of the work launched inside the program's
``psg.ms_deform_attn`` spans (every call of the op, encoder and decoder),
per image, in the traced run's span pass (:mod:`psgbench.spans`); nothing
where the program opens no such span."""

from psgbench.spans import per_image


def read(ctx):
    return per_image(ctx, "psg.ms_deform_attn",
                     lambda tr: 1e3 * tr.span_device_s("psg.ms_deform_attn"))
