"""Class-name language encoders (counterpart of
``openpsg_tpu/models/segmenter/language.py``).

``PSGv4`` runs one once at construction: class names are byte-encoded
(:func:`encode_names`) and the :class:`TextEncoder` gives the unit-norm
class embedding matrix the query decoder classifies against.  Parameter
names mirror the flax module's, so :mod:`openpsg_tpu_torch.bridge` maps the
JAX ``text`` tree onto it.

With published weights the matrix comes instead from OpenSeeD's CLIP text
tower (:func:`clip_class_embeddings`, run by the ``convert_openseed``
tool), saved as the ``.npy`` that ``precomputed_class_embeds`` names.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from openpsg_tpu_torch.models.common import LayerNorm
from openpsg_tpu_torch.models.commons.text_encoder import (
    BertStyleConfig,
    BertStyleEncoder,
    load_tree,
)

MAX_NAME_LEN = 32
BYTE_VOCAB = 257  # 256 bytes + padding id 256
LN_EPS = 1e-6     # flax LayerNorm's default (torch's is 1e-5)


def encode_names(names: List[str], max_len: int = MAX_NAME_LEN) -> np.ndarray:
    """Byte-encode lower-cased class names to a [N, max_len] int32 batch,
    cut to ``max_len`` bytes, padded with id 256."""
    out = np.full((len(names), max_len), BYTE_VOCAB - 1, np.int32)
    for i, name in enumerate(names):
        b = name.lower().encode("utf-8")[:max_len]
        out[i, : len(b)] = np.frombuffer(b, np.uint8)
    return out


class _SelfAttention(nn.Module):
    """flax ``MultiHeadDotProductAttention`` over one sequence: q/k/v/out
    projections with biases, keys masked with the float32 minimum."""

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.query = nn.Linear(dim, dim)
        self.key = nn.Linear(dim, dim)
        self.value = nn.Linear(dim, dim)
        self.out = nn.Linear(dim, dim)

    def forward(self, x, key_mask):
        """x [N, L, D]; key_mask [N, L] bool (False = padding)."""
        N, L, D = x.shape
        H = self.num_heads
        split = lambda t: t.reshape(N, L, H, D // H).transpose(1, 2)
        q = split(self.query(x)) / (D // H) ** 0.5
        k, v = split(self.key(x)), split(self.value(x))
        logits = torch.einsum("nhqd,nhkd->nhqk", q, k)
        logits = logits.masked_fill(~key_mask[:, None, None, :], torch.finfo(logits.dtype).min)
        attn = torch.softmax(logits, dim=-1)
        o = torch.einsum("nhqk,nhkd->nhqd", attn, v)
        return self.out(o.transpose(1, 2).reshape(N, L, D))


class TextEncoder(nn.Module):
    """Byte-level pre-LN transformer: ``depth`` blocks (attention, exact
    GELU MLP), final LayerNorm, masked mean pool, bias-free projection, and
    a float32 unit norm (``x / (|x| + 1e-6)``).  token_ids [N, L] → [N, dim].
    Layers carry the flax module's names (``ln1_{i}``, ``attn{i}``, ...)."""

    def __init__(self, dim: int = 256, depth: int = 4, num_heads: int = 8,
                 max_len: int = MAX_NAME_LEN):
        super().__init__()
        self.depth = depth
        self.tok_embed = nn.Embedding(BYTE_VOCAB, dim)
        self.pos_embed = nn.Parameter(torch.empty(max_len, dim))
        for i in range(depth):
            self.add_module(f"ln1_{i}", LayerNorm(dim, eps=LN_EPS))
            self.add_module(f"attn{i}", _SelfAttention(dim, num_heads))
            self.add_module(f"ln2_{i}", LayerNorm(dim, eps=LN_EPS))
            self.add_module(f"mlp1_{i}", nn.Linear(dim, 4 * dim))
            self.add_module(f"mlp2_{i}", nn.Linear(4 * dim, dim))
        self.ln_final = LayerNorm(dim, eps=LN_EPS)
        self.proj = nn.Linear(dim, dim, bias=False)

    def init_extra(self, gen):
        self.pos_embed.normal_(0.0, 0.01, generator=gen)

    def forward(self, token_ids: torch.Tensor) -> torch.Tensor:
        L = token_ids.shape[1]
        pad_mask = token_ids != BYTE_VOCAB - 1
        x = self.tok_embed(token_ids.long()) + self.pos_embed[:L]
        for i in range(self.depth):
            x = x + getattr(self, f"attn{i}")(getattr(self, f"ln1_{i}")(x), pad_mask)
            h = getattr(self, f"mlp1_{i}")(getattr(self, f"ln2_{i}")(x))
            x = x + getattr(self, f"mlp2_{i}")(F.gelu(h, approximate="none"))
        x = self.ln_final(x)
        m = pad_mask[..., None].to(x.dtype)
        pooled = (x * m).sum(dim=1) / m.sum(dim=1).clamp(min=1.0)
        pooled = self.proj(pooled).float()
        return pooled / (pooled.norm(dim=-1, keepdim=True) + 1e-6)


def clip_text_tower_config(width: int = 512, layers: int = 12, heads: int = 8,
                           vocab: int = 49408):
    """BertStyleConfig of the OpenSeeD/CLIP language tower (pre-LN,
    quickGELU, causal: the OpenAI CLIP text architecture X-Decoder reuses);
    defaults are CLIP ViT-B's text tower."""
    return BertStyleConfig(
        hidden_size=width, num_layers=layers, num_heads=heads,
        intermediate=4 * width, vocab_size=vocab, max_len=77,
        pre_ln=True, quick_gelu=True, causal=True, ln_eps=1e-5,
    )


@torch.no_grad()
def clip_class_embeddings(tower_cfg, tower_params, lang_proj: np.ndarray, tokenizer,
                          names: List[str], templates: Sequence[str] = ("{}",),
                          device="cpu") -> np.ndarray:
    """Class names → unit-norm [N, proj_dim] float32 embeddings, OpenSeeD's
    ``lang_encoder.get_text_embeddings(thing+stuff)``
    (openseed_relation_v2.py:59-60): CLIP-BPE tokenize, run the converted
    CLIP text tower (``tower_params``, the flax-layout tree
    ``convert_openseed_lang`` gives), take the EOT position (the largest
    id), project through ``lang_proj``, normalize; several prompt
    templates are averaged, then renormalized.  Save the result with
    ``np.save`` for ``precomputed_class_embeds``."""
    tower_params = dict(tower_params)
    if "pooler" not in tower_params:
        # converted CLIP weights have no BERT pooler, which the module
        # always builds (unused on this path): zeros
        D = tower_cfg.hidden_size
        tower_params["pooler"] = {"kernel": np.zeros((D, D), np.float32),
                                  "bias": np.zeros((D,), np.float32)}
    with torch.device("meta"):
        enc = BertStyleEncoder(tower_cfg)
    enc = enc.to_empty(device=device).eval()
    load_tree(enc, tower_params)
    proj = torch.as_tensor(np.asarray(lang_proj, np.float32), device=device)
    embs = []
    for tmpl in templates:
        ids = torch.from_numpy(np.asarray(tokenizer([tmpl.format(n) for n in names]))).to(device)
        x = enc(token_ids=ids)                                   # [N, 77, D]
        pooled = x[torch.arange(x.shape[0], device=device), ids.argmax(dim=-1)]
        emb = pooled.float() @ proj
        embs.append(emb / (emb.norm(dim=-1, keepdim=True) + 1e-6))
    out = torch.stack(embs).mean(0)
    out = out / (out.norm(dim=-1, keepdim=True) + 1e-6)
    return out.cpu().numpy()
