"""HF Llama checkpoints → the port's LLM state dict (counterpart of
``openpsg_tpu/models/llm/weight_convert.py``).

The reference loads ``meta-llama/Llama-2-7b-hf`` through HF
(relation_transformer_head_v4.py:99-105).  :func:`convert_llama` maps an HF
state dict straight onto :class:`~openpsg_tpu_torch.models.llm.llama.
LlamaWithEmbeddings`: the port keeps torch's ``[out, in]`` layout, so the
map is a rename (no transpose, no stacked layer axis and no flax-layout
copy of 13.5 GB at 7B), each tensor cast to the config's dtype; with
``cfg.quant`` the result goes through :func:`quantize_llama`.  HF uses the
rotate-half RoPE convention the port implements, so weights load
unpermuted; ``llm_truncate_num`` keeps the first ``cfg.n_layers`` layers.

The result equals the JAX ``convert_llama`` (then ``quantize_llama`` when
quantized) mapped by :mod:`openpsg_tpu_torch.bridge`.
"""

from __future__ import annotations

from typing import Dict, Mapping, Union

import numpy as np
import torch

from openpsg_tpu_torch.models.llm.llama import LlamaConfig, quantize_llama

_LAYER_MAP = {
    "self_attn.q_proj.weight": "wq.weight",
    "self_attn.k_proj.weight": "wk.weight",
    "self_attn.v_proj.weight": "wv.weight",
    "self_attn.o_proj.weight": "wo.weight",
    "mlp.gate_proj.weight": "w_gate.weight",
    "mlp.up_proj.weight": "w_up.weight",
    "mlp.down_proj.weight": "w_down.weight",
    "input_layernorm.weight": "attn_norm.weight",
    "post_attention_layernorm.weight": "ffn_norm.weight",
}

ArrayLike = Union[np.ndarray, torch.Tensor]


def to_numpy(v) -> np.ndarray:
    """A tensor (bf16 widened to float32) or array-like → numpy."""
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu()
        return (v.float() if v.dtype == torch.bfloat16 else v).numpy()
    return np.asarray(v)


def load_state_dict(path: str) -> Dict[str, np.ndarray]:
    """A ``.pt`` / ``.bin`` (torch) or ``.safetensors`` checkpoint → numpy
    on the host; a ``state_dict`` entry is unwrapped.  ``safetensors`` is
    imported only for its files."""
    if path.endswith(".safetensors"):
        from safetensors.numpy import load_file

        return dict(load_file(path))
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if "state_dict" in sd and isinstance(sd["state_dict"], dict):
        sd = sd["state_dict"]
    return {k: to_numpy(v) for k, v in sd.items()}


def _tensor(v: ArrayLike, dtype: torch.dtype) -> torch.Tensor:
    t = v if isinstance(v, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(v))
    return t.to(dtype) if t.is_floating_point() else t


@torch.no_grad()
def convert_llama(state: Mapping[str, ArrayLike], cfg: LlamaConfig,
                  dtype: torch.dtype = None) -> Dict[str, torch.Tensor]:
    """HF ``LlamaForCausalLM`` state dict (numpy or torch values) → the
    state dict of ``LlamaWithEmbeddings(cfg)``: the first ``cfg.n_layers``
    layers, floats in ``dtype`` (default ``cfg.dtype``), quantized when
    ``cfg.quant``."""
    dtype = dtype or cfg.dtype
    prefix = "model." if any(k.startswith("model.") for k in state) else ""
    out = {"tok_embed.weight": _tensor(state[f"{prefix}embed_tokens.weight"], dtype)}
    for i in range(cfg.n_layers):
        for hf, ours in _LAYER_MAP.items():
            out[f"core.layers.{i}.{ours}"] = _tensor(state[f"{prefix}layers.{i}.{hf}"], dtype)
    out["core.final_norm.weight"] = _tensor(state[f"{prefix}norm.weight"], dtype)
    out["core.lm_head.weight"] = _tensor(state["lm_head.weight"], dtype)
    return quantize_llama(out) if cfg.quant else out


def verify_structure(converted: Mapping[str, ArrayLike],
                     reference: Mapping[str, ArrayLike]) -> None:
    """Raise if the converted state dict's names or shapes differ from a
    reference one (e.g. ``module.state_dict()``): layout drift shows
    before any weight loads."""
    shape = lambda v: tuple(v.shape)
    ref = {k: shape(v) for k, v in reference.items()}
    got = {k: shape(v) for k, v in converted.items()}
    missing, extra = set(ref) - set(got), set(got) - set(ref)
    mismatch = {k: (got[k], ref[k]) for k in set(got) & set(ref) if got[k] != ref[k]}
    if missing or extra or mismatch:
        raise ValueError(f"param layout drift: missing={sorted(missing)} "
                         f"extra={sorted(extra)} mismatch={mismatch}")


_META_LAYER_MAP = {
    "attention.wq.weight": "self_attn.q_proj.weight",
    "attention.wk.weight": "self_attn.k_proj.weight",
    "attention.wv.weight": "self_attn.v_proj.weight",
    "attention.wo.weight": "self_attn.o_proj.weight",
    "feed_forward.w1.weight": "mlp.gate_proj.weight",
    "feed_forward.w2.weight": "mlp.down_proj.weight",
    "feed_forward.w3.weight": "mlp.up_proj.weight",
    "attention_norm.weight": "input_layernorm.weight",
    "ffn_norm.weight": "post_attention_layernorm.weight",
}


def meta_llama_to_hf_state(state: Mapping[str, ArrayLike], n_heads: int, n_kv_heads: int,
                           prefix: str = "") -> Dict[str, np.ndarray]:
    """Meta/original-llama state layout (wq/wk/wv/wo, feed_forward w1/w2/w3,
    tok_embeddings/norm/output; INTERLEAVED RoPE) → the HF layout
    :func:`convert_llama` reads (rotate-half RoPE): q/k projections are
    permuted as HF's ``convert_llama_weights_to_hf`` does, everything else
    renames; other keys (``freqs_cis`` buffers, shards) are dropped."""

    def permute(w: np.ndarray, heads: int) -> np.ndarray:
        d1, d2 = w.shape
        return w.reshape(heads, d1 // heads // 2, 2, d2).transpose(0, 2, 1, 3).reshape(d1, d2)

    out: Dict[str, np.ndarray] = {}
    for key, val in state.items():
        if not key.startswith(prefix):
            continue
        k = key[len(prefix):]
        v = to_numpy(val)
        if k == "tok_embeddings.weight":
            out["model.embed_tokens.weight"] = v
        elif k == "norm.weight":
            out["model.norm.weight"] = v
        elif k == "output.weight":
            out["lm_head.weight"] = v
        elif k.startswith("layers."):
            _, i, rest = k.split(".", 2)
            hf = _META_LAYER_MAP.get(rest)
            if hf is None:
                continue
            if rest == "attention.wq.weight":
                v = permute(v, n_heads)
            elif rest == "attention.wk.weight":
                v = permute(v, n_kv_heads)
            out[f"model.layers.{i}.{hf}"] = v
    return out
