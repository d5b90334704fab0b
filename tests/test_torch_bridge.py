"""The JAX → port parameter bridge on the tiny PSGv4 tree: every leaf is
used exactly once, lands transformed, and a missing, extra or misshapen
leaf is refused; the same for a tree whose LLM went through the JAX
``quantize_llama`` (int8 ``kernel_q``, per-channel ``scale``)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openpsg_tpu.models.detectors.psg_v4 import PSGv4 as JaxPSGv4
from openpsg_tpu.models.detectors.psg_v4 import PSGv4Config as JaxPSGv4Config
from openpsg_tpu.models.llm.llama import quantize_llama
from openpsg_tpu_torch import bridge
from openpsg_tpu_torch.models.detectors.psg_v4 import PSGv4, PSGv4Config


def _copy(tree):
    return {k: _copy(v) if isinstance(v, dict) else v for k, v in tree.items()}


@pytest.fixture(scope="module")
def tiny():
    jp = JaxPSGv4(JaxPSGv4Config.tiny_test(), jax.random.PRNGKey(0))
    params = jax.tree_util.tree_map(np.asarray, jax.device_get(jp.params))
    model = PSGv4(PSGv4Config.tiny_test(), seed=0, device="cpu")
    report = bridge.load_jax_params(model, params)
    return params, model, report


class TestAccounting:
    @pytest.mark.parametrize("part", bridge.MODULE_PARTS)
    def test_every_leaf_used_once(self, tiny, part):
        params, model, report = tiny
        expected = 0
        for path, arr in bridge._leaves(params[part]["params"], (part,)):
            scanned = any(path[: len(k)] == k for k in bridge.SCANNED)
            expected += arr.shape[0] if scanned else 1
        names = bridge.part_state_dict(part, params[part])
        assert len(names) == expected
        assert set(names) == set(getattr(model, part).state_dict())
        assert report["used"][part] == sum(1 for _ in bridge._leaves(params[part]["params"]))

    def test_text_is_the_only_unused_part(self, tiny):
        """No part is left unused now that the language encoder is ported:
        ``text`` loads into ``model.text``, and ``class_embeds`` is taken as
        the JAX tree holds it."""
        params, model, report = tiny
        assert set(report["used"]) == set(params) == set(bridge.MODULE_PARTS) | {"class_embeds"}
        np.testing.assert_array_equal(model.class_embeds.numpy(), params["class_embeds"])

    @pytest.mark.parametrize("edit", ["missing", "extra", "shape"])
    def test_refuses_a_bad_tree(self, tiny, edit):
        params = _copy(tiny[0])
        blk = params["head"]["params"]["qformer"]["self_attn0"]["q"]
        if edit == "missing":
            del blk["bias"]
        elif edit == "extra":
            blk["bogus"] = np.zeros(3, np.float32)
        else:
            blk["bias"] = np.zeros(5, np.float32)
        model = PSGv4(PSGv4Config.tiny_test(), seed=1, device="cpu")
        with pytest.raises((RuntimeError, ValueError)):
            bridge.load_jax_params(model, params)


class TestLayouts:
    def test_dense_conv_mha_embed_and_scan(self, tiny):
        params, model, _ = tiny
        seg, head, llm = (params[p]["params"] for p in ("segmenter", "head", "llm"))
        sd = {p: getattr(model, p).state_dict() for p in bridge.MODULE_PARTS}
        pairs = [
            (sd["segmenter"]["backbone.patch_embed.weight"],
             seg["backbone"]["patch_embed"]["kernel"].transpose(3, 2, 0, 1)),
            (sd["segmenter"]["backbone.stage0_block0.norm1.weight"],
             seg["backbone"]["stage0_block0"]["norm1"]["scale"]),
            (sd["segmenter"]["decoder.layers.1.self_attn.mha.query.weight"],
             seg["decoder"]["layers"]["self_attn"]["mha"]["query"]["kernel"][1]
             .reshape(32, -1).T),
            (sd["segmenter"]["decoder.layers.1.self_attn.mha.out.weight"],
             seg["decoder"]["layers"]["self_attn"]["mha"]["out"]["kernel"][1]
             .reshape(-1, 32).T),
            (sd["segmenter"]["pixel_decoder.layers.0.ffn.fc1.weight"],
             seg["pixel_decoder"]["layers"]["layer"]["ffn"]["fc1"]["kernel"][0].T),
            (sd["head"]["qformer.word_embed.weight"],
             head["qformer"]["word_embed"]["embedding"]),
            (sd["llm"]["core.layers.1.wq.weight"],
             llm["core"]["layers"]["wq"]["kernel"][1].T),
            (sd["llm"]["tok_embed.weight"], llm["tok_embed"]["embedding"]),
        ]
        for got, want in pairs:
            np.testing.assert_array_equal(got.numpy(), want)

    def test_rmsnorm_matches_jax(self, tiny):
        from openpsg_tpu.models.llm.llama import RMSNorm as JaxRMSNorm

        from openpsg_tpu_torch.models.llm.llama import RMSNorm

        w = tiny[0]["llm"]["params"]["core"]["final_norm"]["weight"]
        x = np.random.default_rng(0).normal(size=(3, 5, 64)).astype(np.float32)
        want = JaxRMSNorm(64, 1e-5, jnp.float32).apply(
            {"params": {"weight": jnp.asarray(w)}}, jnp.asarray(x))
        norm = RMSNorm(64, 1e-5)
        norm.load_state_dict({"weight": torch.from_numpy(np.array(w))})
        got = norm(torch.from_numpy(x)).detach().numpy()
        np.testing.assert_allclose(got, np.asarray(want), atol=1e-5, rtol=1e-5)


@pytest.fixture(scope="module")
def quantized(tiny):
    params = dict(tiny[0])
    params["llm"] = jax.tree_util.tree_map(np.asarray, quantize_llama(params["llm"]))
    cfg = PSGv4Config.tiny_test()
    cfg = dataclasses.replace(cfg, llm=dataclasses.replace(cfg.llm, quant=True, act_int8=True))
    model = PSGv4(cfg, seed=0, device="cpu")
    report = bridge.load_jax_params(model, params)
    return params, model, report


class TestQuantizedTree:
    def test_every_leaf_used_once(self, quantized):
        params, model, report = quantized
        tree = params["llm"]
        expected = sum(arr.shape[0] if any(path[: len(k)] == k for k in bridge.SCANNED) else 1
                       for path, arr in bridge._leaves(tree["params"], ("llm",)))
        names = bridge.part_state_dict("llm", tree)
        assert len(names) == expected
        assert set(names) == set(model.llm.state_dict())
        assert report["used"]["llm"] == sum(1 for _ in bridge._leaves(tree["params"]))

    def test_int8_leaves_and_scales(self, quantized):
        params, model, _ = quantized
        sd = model.llm.state_dict()
        layers = params["llm"]["params"]["core"]["layers"]
        for i in range(layers["wq"]["kernel_q"].shape[0]):
            wq = sd[f"core.layers.{i}.w_up.weight_q"]
            assert wq.dtype == torch.int8
            np.testing.assert_array_equal(wq.numpy(), layers["w_up"]["kernel_q"][i].T)
            scale = sd[f"core.layers.{i}.w_up.scale"]
            assert scale.dtype == torch.float32
            np.testing.assert_array_equal(scale.numpy(), layers["w_up"]["scale"][i])
            np.testing.assert_array_equal(sd[f"core.layers.{i}.attn_norm.weight"].numpy(),
                                          layers["attn_norm"]["weight"][i])
        head = params["llm"]["params"]["core"]["lm_head"]
        np.testing.assert_array_equal(sd["core.lm_head.weight_q"].numpy(), head["kernel_q"].T)
        np.testing.assert_array_equal(sd["core.lm_head.scale"].numpy(), head["scale"])
        assert not any(n.endswith(".weight") and "w_up" in n for n in sd)

    def test_norm_scale_still_becomes_weight(self, quantized):
        params, model, _ = quantized
        np.testing.assert_array_equal(
            model.segmenter.state_dict()["backbone.stage0_block0.norm1.weight"].numpy(),
            params["segmenter"]["params"]["backbone"]["stage0_block0"]["norm1"]["scale"])
