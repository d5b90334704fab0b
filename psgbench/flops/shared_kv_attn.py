"""Shared-KV masked cross-attention (``flash_shared_kv_cross_attn``): every
pair's Lq queries attend to the same P patch keys and values under its own
mask.  Operations: QKᵀ and PV, 2 each per multiply-add.  Bytes: q and the
output once each, k and v once, the bool mask once (bf16 elements)."""

from psgbench.flops import least_seconds

# the kernel's device functions as the profiler names them
KERNEL_NAMES = ("skv_hopper_kernel", "skv_attn_kernel", "pack_mask_bits")


def counts(NP: int, H: int, Lq: int, P: int, hd: int, elem: int = 2):
    flops = 2 * 2 * NP * H * Lq * P * hd
    nbytes = 2 * NP * H * Lq * hd * elem + 2 * H * P * hd * elem + NP * P
    return {"flops": flops, "bytes": nbytes}


def bound_s(NP: int, H: int, Lq: int, P: int, hd: int) -> float:
    c = counts(NP, H, Lq, P, hd)
    return least_seconds(c["flops"], c["bytes"])


def is_kernel(name: str) -> bool:
    return any(k in name for k in KERNEL_NAMES)
