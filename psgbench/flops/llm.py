"""A Llama-architecture decoder's prefill and decode trips (HF config
names).  Operations: 2 per multiply-add of every product: the projections,
attention over the keys each query may see, and the LM head on the rows
whose logits are taken.  Bytes (bf16): every weight read once, the input
embeddings read, the keys and values written, and in a trip the cached
keys and values read."""

from psgbench.flops import least_seconds


def _sizes(c):
    D, H, KV = c["hidden_size"], c["num_attention_heads"], c["num_key_value_heads"]
    hd = D // H
    F, V, Lyr = c["intermediate_size"], c["vocab_size"], c["num_hidden_layers"]
    per_layer = D * H * hd + 2 * D * KV * hd + H * hd * D + 3 * D * F
    return D, H, KV, hd, V, Lyr, per_layer


def prefill(c, rows: int, L: int, elem: int = 2):
    """One cache-free forward over [rows, L] tokens, logits of the last."""
    D, H, KV, hd, V, Lyr, per_layer = _sizes(c)
    tokens = rows * L
    attn = 2 * 2 * rows * H * hd * (L * (L + 1) // 2) * Lyr
    flops = 2 * tokens * per_layer * Lyr + attn + 2 * rows * D * V
    nbytes = (per_layer * Lyr + D * V) * elem + tokens * D * elem \
        + 2 * tokens * KV * hd * Lyr * elem
    return {"flops": flops, "bytes": nbytes}


def trip(c, rows: int, keys: int, elem: int = 2):
    """One decode step: a token per row attending to ``keys`` keys."""
    D, H, KV, hd, V, Lyr, per_layer = _sizes(c)
    flops = 2 * rows * per_layer * Lyr + 2 * 2 * rows * H * hd * keys * Lyr + 2 * rows * D * V
    nbytes = (per_layer * Lyr + D * V) * elem + rows * D * elem \
        + 2 * rows * keys * KV * hd * Lyr * elem
    return {"flops": flops, "bytes": nbytes}


def decode_bound_s(c, rows: int, Lp: int, trips: int) -> float:
    """The least time of a prefill over [rows, Lp] and ``trips`` trips."""
    p = prefill(c, rows, Lp)
    s = least_seconds(p["flops"], p["bytes"])
    for t in range(trips):
        d = trip(c, rows, Lp + t + 1)
        s += least_seconds(d["flops"], d["bytes"])
    return s
