"""The expert layers' share of their roofline, in percent, in the traced
run's span pass (:mod:`psgbench.spans`): the least time of the pass's
``psg.moe`` calls over the device time of the work launched inside them.

The least time is taken per phase, prefill and trips: the operations of
that phase's calls at the bf16 peak or their bytes at the memory
bandwidth, whichever is larger (``flops/moe_mla.py`` ``moe_call``: the
routed and shared rows' products; the weights of ``min(E, rows · k)``
routed experts and the shared experts read once a call, and the rows in
and out).  Summed per phase before the larger is taken, it is at most the
sum of each call's own least time, so the share cannot pass what the
calls allow.  The pass runs one chunk per bucket: each chunk's rows are
``System.decode_shape``'s pairs per image times its images, its prefill
``Lp`` tokens a row, each trip one.  Nothing where the program opens no
``psg.moe`` span or the count of its calls does not match."""

from psgbench.flops import least_seconds, moe_mla
from psgbench.spans import span_pass


def read(ctx):
    sp = span_pass(ctx)
    sys_ = ctx["system"]
    if not sp or not hasattr(sys_, "decode_shape") or not hasattr(sys_, "llm_cfg"):
        return None
    tr = sp["trace"]
    calls, chunks, trips = (tr.span_count(n) for n in ("psg.moe", "psg.prefill", "psg.trip"))
    c = sys_.llm_cfg
    n_moe = c["num_hidden_layers"] - c["first_k_dense_replace"]
    spent = tr.span_device_s("psg.moe")
    if not calls or not chunks or calls != n_moe * (chunks + trips) or spent <= 0:
        return None
    per_image, Lp, _ = sys_.decode_shape()
    rows = per_image * sp["images"] // chunks
    bound = 0.0
    for n_calls, tokens in ((n_moe * chunks, rows * Lp), (n_moe * trips, rows)):
        one = moe_mla.moe_call(c, tokens)
        bound += least_seconds(n_calls * one["flops"], n_calls * one["bytes"])
    return 100.0 * bound / spent
