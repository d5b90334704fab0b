"""InteractiveFusionModule: object (node) and predicate-text (edge)
embeddings → dense relation scores (counterpart of
``openpsg_tpu/models/commons/interactive_fusion.py``; reference
kings_sgg/models/relation_heads/interactive_fusion_module.py:8-68).

Without the graph transformer, ``cls_s`` / ``cls_o`` / ``cls_r`` are plain
Linears from the raw input widths to ``output_size``.  With it,
``fc_node`` / ``fc_edge`` project both to ``output_size``, the
:class:`GraphTransformer` passes messages, and ``cls_*`` are
:class:`RefMLP` blocks.  Scoring modes:

* ``attention``: pair product sub⊗obj → ``fc_q``, relations → ``fc_k``,
  logits q·kᵀ/√output_size;
* ``einsum``: ``einsum('nsc,noc,rc->nrso')``, unscaled;
* ``einsum_v1``: the same contraction through the explicit pair product;
* ``einsum_v2``: ``einsum_v1`` gated by sigmoid(sub·obj).

Output: [B, R, N, N] float32 scores.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from openpsg_tpu_torch.models.commons.graph_transformer import GraphTransformer
from openpsg_tpu_torch.models.common import LayerNorm, mm_f32


class RefMLP(nn.Module):
    """The reference fusion MLP: fc1 → LayerNorm (named ``act``) → fc2."""

    def __init__(self, in_dim: int, hidden: int, out: int):
        super().__init__()
        self.fc1 = nn.Linear(in_dim, hidden)
        self.act = LayerNorm(hidden, eps=1e-5)
        self.fc2 = nn.Linear(hidden, out)

    def forward(self, x):
        return self.fc2(self.act(self.fc1(x)))


class InteractiveFusionModule(nn.Module):
    def __init__(self, node_dim: int, edge_dim: int, pred_type: str = "einsum",
                 output_size: int = 64, use_graph_transformer: bool = False):
        super().__init__()
        if pred_type not in ("attention", "einsum", "einsum_v1", "einsum_v2"):
            raise ValueError(pred_type)
        self.pred_type, self.use_graph = pred_type, use_graph_transformer
        D = output_size
        if use_graph_transformer:
            self.fc_node = nn.Linear(node_dim, D)
            self.fc_edge = nn.Linear(edge_dim, D)
            self.graph = GraphTransformer(D)
            self.cls_s, self.cls_o, self.cls_r = (RefMLP(D, 2 * D, D) for _ in range(3))
        else:
            self.cls_s = nn.Linear(node_dim, D)
            self.cls_o = nn.Linear(node_dim, D)
            self.cls_r = nn.Linear(edge_dim, D)
        if pred_type == "attention":
            self.fc_q = RefMLP(D, 2 * D, D)
            self.fc_k = RefMLP(D, 2 * D, D)

    def forward(self, nodes, edges):
        """nodes [B, N, Do]; edges [R, De] → [B, R, N, N]."""
        if edges.ndim == 3:           # a batched edge table: its first row
            edges = edges[0]
        if self.use_graph:
            nodes, edges = self.graph(self.fc_node(nodes), self.fc_edge(edges))
        sub, obj, rel = self.cls_s(nodes), self.cls_o(nodes), self.cls_r(edges)
        B, N, D = sub.shape
        R = rel.shape[0]
        if self.pred_type == "attention":
            so = torch.einsum("nsc,noc->nsoc", sub, obj).reshape(B, N * N, D)
            q = self.fc_q(so)
            k = self.fc_k(rel[None].expand(B, R, D))
            pred = mm_f32(q, k, "bpc,brc->bpr") / (D ** 0.5)
            return pred.reshape(B, N, N, R).permute(0, 3, 1, 2)
        if self.pred_type == "einsum":
            return torch.einsum("nsc,noc,rc->nrso", sub.float(), obj.float(), rel.float())
        pair = torch.einsum("nsc,noc->nsoc", sub, obj)
        scores = mm_f32(pair, rel, "nsoc,rc->nrso")
        if self.pred_type == "einsum_v2":
            gate = torch.sigmoid(torch.einsum("nsc,noc->nso", sub, obj).float())
            scores = scores * gate[:, None]
        return scores
