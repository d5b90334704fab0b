"""Device ms of the work launched inside the program's ``psg.mla`` spans
(each latent-attention call of the LLM, prefill and trips), per image, in
the traced run's span pass (:mod:`psgbench.spans`); nothing where the
program opens no such span."""

from psgbench.spans import per_image


def read(ctx):
    return per_image(ctx, "psg.mla", lambda tr: 1e3 * tr.span_device_s("psg.mla"))
