"""A DeepSeek-V3-architecture decoder's prefill and decode trips (HF config
names): multi-head latent attention and the expert layers.

Operations: 2 per multiply-add of the products the program computes, only
the active ones: the attention projections, the dense layers' SwiGLU, each
expert layer's router, its routed experts on the rows routed to them
(``num_experts_per_tok`` a token) and its shared experts, attention over
the keys each query may see, and the LM head on the rows whose logits are
taken.  The prefill computes MLA expanded (keys and values per head from
``kv_b_proj``); a trip computes it absorbed (``W_UK`` folded into the
query, scores and weighted sums over the latent cache, ``W_UV`` after).

Bytes (bf16): every weight read once (the LM head's, not the embedding
table's), but of a layer's routed experts only
``min(E, rows · k)``, the most that ``rows`` tokens can pick; the input
embeddings read; the latent cache (latent and ``k_pe``) written, and in a
trip read over its keys.  :func:`moe_call` counts one expert layer's call
alone, for the expert layer's own roofline."""


def _sizes(c):
    D, H, R = c["hidden_size"], c["num_attention_heads"], c["kv_lora_rank"]
    nope, rp, vd = c["qk_nope_head_dim"], c["qk_rope_head_dim"], c["v_head_dim"]
    attn = D * H * (nope + rp) + D * (R + rp) + R * H * (nope + vd) + H * vd * D
    dense = 3 * D * c["intermediate_size"]
    n_dense = c["first_k_dense_replace"]
    return D, H, R, nope, rp, vd, attn, dense, n_dense, c["num_hidden_layers"] - n_dense


def moe_call(c, tokens: int, elem: int = 2):
    """One expert layer over ``tokens`` tokens: router, routed experts,
    shared experts → {"flops", "bytes"}; the bytes are the weights read
    (routed experts ``min(E, tokens · k)``) and the rows in and out."""
    D, E, k = c["hidden_size"], c["n_routed_experts"], c["num_experts_per_tok"]
    expert = 3 * D * c["moe_intermediate_size"]
    shared = c["n_shared_experts"] * expert
    flops = 2 * tokens * (D * E + k * expert + shared)
    nbytes = (D * E + min(E, tokens * k) * expert + shared) * elem + 2 * tokens * D * elem
    return {"flops": flops, "bytes": nbytes}


def prefill(c, rows: int, L: int, elem: int = 2):
    """One cache-free forward over [rows, L] tokens, logits of the last."""
    D, H, R, nope, rp, vd, attn, dense, n_dense, n_moe = _sizes(c)
    V = c["vocab_size"]
    tokens = rows * L
    pairs = rows * (L * (L + 1) // 2)
    per_attn = 2 * tokens * attn + 2 * pairs * H * (nope + rp + vd)
    moe = moe_call(c, tokens, elem)
    flops = (n_dense + n_moe) * per_attn + n_dense * 2 * tokens * dense \
        + n_moe * moe["flops"] + 2 * rows * D * V
    weights = (n_dense + n_moe) * attn + n_dense * dense + D * V
    nbytes = weights * elem + n_moe * moe["bytes"] + tokens * D * elem \
        + (n_dense + n_moe) * tokens * (R + rp) * elem
    return {"flops": flops, "bytes": nbytes}


def trip(c, rows: int, keys: int, elem: int = 2):
    """One decode step: a token per row attending to ``keys`` cache
    entries, absorbed."""
    D, H, R, nope, rp, vd, attn, dense, n_dense, n_moe = _sizes(c)
    V = c["vocab_size"]
    # q_proj, kv_a, W_UK on the query, scores over latent and k_pe, the
    # weighted latent sum, W_UV, o_proj
    per_attn = 2 * rows * (D * H * (nope + rp) + D * (R + rp) + H * nope * R + H * R * vd
                           + H * vd * D) + 2 * rows * keys * H * (R + rp + R)
    moe = moe_call(c, rows, elem)
    flops = (n_dense + n_moe) * per_attn + n_dense * 2 * rows * dense \
        + n_moe * moe["flops"] + 2 * rows * D * V
    weights = (n_dense + n_moe) * attn + n_dense * dense + D * V
    nbytes = weights * elem + n_moe * moe["bytes"] + rows * D * elem \
        + (n_dense + n_moe) * rows * keys * (R + rp) * elem
    return {"flops": flops, "bytes": nbytes}

