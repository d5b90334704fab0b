"""The shared-KV cross-attention kernel's share of its roofline, in
percent: the least time of every call in the profiled phase (each call's
shape from its image's bucket, ``System.shared_kv_calls``; operations and
bytes by ``flops/shared_kv_attn.py``) over the kernel's device time in the
trace.  Nothing where the kernel did not run."""

from psgbench.flops import shared_kv_attn


def read(ctx):
    ph = ctx["phases"].get("profiled")
    sys_ = ctx["system"]
    if not ph or "trace" not in ph or not hasattr(sys_, "shared_kv_calls"):
        return None
    t = ph["trace"].device_time_s(shared_kv_attn.is_kernel)
    if t <= 0:
        return None
    bound = sum(n * sum(shared_kv_attn.bound_s(*c) for c in sys_.shared_kv_calls(b))
                for b, n in ph["buckets"].items())
    return 100.0 * bound / t
