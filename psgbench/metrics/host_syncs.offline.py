"""Host calls that wait for the card (stream, device and event
synchronizes, blocking copies) made inside the program's ``psg.infer``
spans, per image, in the traced run's span pass (:mod:`psgbench.spans`);
nothing where the program opens no such span."""

from psgbench.spans import per_image


def read(ctx):
    return per_image(ctx, "psg.infer", lambda tr: tr.span_syncs("psg.infer"))
