"""Host launches (kernels, a CUDA graph once, asynchronous copies and
sets) made inside the program's ``psg.segmenter`` spans, per image, in the
traced run's span pass (:mod:`psgbench.spans`); nothing where the program
opens no such span."""

from psgbench.spans import per_image


def read(ctx):
    return per_image(ctx, "psg.segmenter", lambda tr: tr.span_launches("psg.segmenter"))
