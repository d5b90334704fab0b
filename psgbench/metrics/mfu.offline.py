"""Model operations per second over the card's bf16 peak, in percent: the
operations of every image completed in the traced run's plain phase
(counted from shapes per bucket, ``System.flops_per_image``) over that
phase's seconds."""

from psgbench.flops import PEAK_BF16_FLOPS


def read(ctx):
    ph = ctx["phases"].get("plain")
    if not ph or not ph["images"]:
        return None
    sys_ = ctx["system"]
    flops = sum(n * sys_.flops_per_image(b) for b, n in ph["buckets"].items())
    return 100.0 * flops / ph["seconds"] / PEAK_BF16_FLOPS
