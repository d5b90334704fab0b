"""The port's graph transformer and interactive fusion module (four
scoring modes, with and without the graph) against the JAX package at tiny
widths: inputs from a numpy seed, flax parameters bridged, float32 outputs
at atol = rtol = 1e-4.
"""

import numpy as np
import pytest

from tests.test_torch_heads_v123 import _f, bridged, close

# ---------------------------------------------------------------- commons
@pytest.mark.parametrize("mode", ["attention", "einsum", "einsum_v1", "einsum_v2"])
@pytest.mark.parametrize("graph", [False, True])
def test_interactive_fusion(mode, graph):
    from openpsg_tpu.models.commons.interactive_fusion import (
        InteractiveFusionModule as JaxFusion,
    )

    from openpsg_tpu_torch.models.commons.interactive_fusion import InteractiveFusionModule

    rng = np.random.default_rng(1)
    nodes = rng.normal(size=(2, 5, 24)).astype(np.float32)
    edges = rng.normal(size=(7, 12)).astype(np.float32)
    jm = JaxFusion(pred_type=mode, output_size=16, use_graph_transformer=graph)
    want, pm = bridged(jm, InteractiveFusionModule(24, 12, mode, 16, graph), nodes, edges)
    got = pm(_f(nodes), _f(edges))
    assert got.shape == (2, 7, 5, 5)
    close(got, want)


def test_graph_transformer():
    from openpsg_tpu.models.commons.graph_transformer import GraphTransformer as JaxGT

    from openpsg_tpu_torch.models.commons.graph_transformer import GraphTransformer

    rng = np.random.default_rng(2)
    nodes = rng.normal(size=(2, 5, 16)).astype(np.float32)
    edges = rng.normal(size=(7, 16)).astype(np.float32)
    jm = JaxGT(16, num_heads=2, num_layers=2, ffn_hidden=32)
    want, pm = bridged(jm, GraphTransformer(16, 2, 2, 32), nodes, edges)
    wn, we = want
    gn, ge = pm(_f(nodes), _f(edges))
    close(gn, wn)
    close(ge, we)
