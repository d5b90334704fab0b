"""The decode stage's least time over its ``stage_times=`` span, in
percent: per chunk of the stage-timed phase, one prefill over the chunk's
rows and prefix and its trips (``flops/llm.py``: each at the larger of its
operations at the bf16 peak and its bytes at the memory bandwidth).
Nothing where the model has no LLM stage."""

from psgbench.flops import llm


def read(ctx):
    ph = ctx["phases"].get("staged")
    sys_ = ctx["system"]
    if not ph or not hasattr(sys_, "decode_shape"):
        return None
    rows, Lp, _ = sys_.decode_shape()
    bound = spent = 0.0
    for c in ph["chunks"]:
        if not c.get("stage") or "decode" not in c["stage"]:
            continue
        bound += llm.decode_bound_s(ctx["config"]["llm"], rows * c["n"], Lp, c["trips"])
        spent += c["stage"]["decode"] * 1e-3
    return 100.0 * bound / spent if spent > 0 else None
