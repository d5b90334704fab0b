"""GraphTransformer: edge↔node message passing through two transformer
decoders (counterpart of ``openpsg_tpu/models/commons/graph_transformer.py``;
reference kings_sgg/models/commons/graph_transformer.py).

Each decoder is torch's ``nn.TransformerDecoder`` with its defaults (8
heads, FFN 2048, ReLU, post-LN, eps 1e-5, no final norm): self-attention →
add & norm → cross-attention → add & norm → FFN → add & norm.
``edge2node`` updates the nodes attending to the (batch-repeated) edges;
``node2edge`` updates the edges attending to the new nodes, then the edges
are averaged over the batch back to the unbatched [R, D] table.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from openpsg_tpu_torch.models.common import LayerNorm


class TorchMHA(nn.Module):
    """``torch.nn.MultiheadAttention`` with separate q/k/v projections (the
    converter splits torch's packed ``in_proj``), softmax in float32."""

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.q = nn.Linear(dim, dim)
        self.k = nn.Linear(dim, dim)
        self.v = nn.Linear(dim, dim)
        self.out = nn.Linear(dim, dim)

    def forward(self, q, k, v):
        """q [B, Lq, D]; k, v [B, Lk, D]."""
        B, Lq, D = q.shape
        H = self.num_heads
        hd = D // H
        qp = self.q(q).reshape(B, Lq, H, hd)
        kp = self.k(k).reshape(B, -1, H, hd)
        vp = self.v(v).reshape(B, -1, H, hd)
        attn = torch.einsum("bqhd,bkhd->bhqk", qp, kp) / (hd ** 0.5)
        attn = torch.softmax(attn.float(), dim=-1).to(qp.dtype)
        out = torch.einsum("bhqk,bkhd->bqhd", attn, vp).reshape(B, Lq, D)
        return self.out(out)


class _DecoderLayer(nn.Module):
    def __init__(self, dim: int, num_heads: int, ffn_hidden: int):
        super().__init__()
        self.self_attn = TorchMHA(dim, num_heads)
        self.ln1 = LayerNorm(dim, eps=1e-5)
        self.cross_attn = TorchMHA(dim, num_heads)
        self.ln2 = LayerNorm(dim, eps=1e-5)
        self.ffn_up = nn.Linear(dim, ffn_hidden)
        self.ffn_down = nn.Linear(ffn_hidden, dim)
        self.ln3 = LayerNorm(dim, eps=1e-5)

    def forward(self, x, mem):
        x = self.ln1(x + self.self_attn(x, x, x))
        x = self.ln2(x + self.cross_attn(x, mem, mem))
        return self.ln3(x + self.ffn_down(torch.relu(self.ffn_up(x))))


class TorchTransformerDecoder(nn.Module):
    """``nn.TransformerDecoder(layer, num_layers)`` without a final norm."""

    def __init__(self, dim: int, num_heads: int = 8, num_layers: int = 3,
                 ffn_hidden: int = 2048):
        super().__init__()
        self.layers = nn.ModuleList(_DecoderLayer(dim, num_heads, ffn_hidden)
                                    for _ in range(num_layers))

    def forward(self, tgt, memory):
        x = tgt
        for layer in self.layers:
            x = layer(x, memory)
        return x


class GraphTransformer(nn.Module):
    def __init__(self, dim: int = 256, num_heads: int = 8, num_layers: int = 3,
                 ffn_hidden: int = 2048):
        super().__init__()
        self.edge2node = TorchTransformerDecoder(dim, num_heads, num_layers, ffn_hidden)
        self.node2edge = TorchTransformerDecoder(dim, num_heads, num_layers, ffn_hidden)

    def forward(self, nodes, edges):
        """nodes [B, N, D]; edges [R, D] → (nodes [B, N, D], edges [R, D]
        averaged over the batch)."""
        edges_b = edges[None].expand(nodes.shape[0], -1, -1)
        nodes = self.edge2node(nodes, edges_b)
        edges_b = self.node2edge(edges_b, nodes)
        return nodes, edges_b.mean(dim=0)
