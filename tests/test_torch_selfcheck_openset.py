"""The port's open-set selfcheck (``openpsg_tpu_torch.tools.selfcheck_openset``)
on the CPU at a few steps: it runs through its four phases (v3 OV head
training on the predicate subset, export, the infer tool with the extended
names, the grader), its exported files restore unchanged into the model
the extended config builds, its token overlaps and learning rates are the
JAX tool's.  The exit rule (held-out R@10 above chance, the tier contrast)
is checked on the card at the default 400 steps.
"""

import os

import numpy as np
import pytest
import torch

from openpsg_tpu_torch.tools import selfcheck_openset as so

# the suite's workers share the cores, and these tensors are tiny: one torch
# thread each, not a pool per worker spinning against the others
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def res(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("openset"))
    return so.run(root, rel_steps=3, device="cpu", log=lambda *a: None)


def test_runs_through_all_four_phases(res):
    assert list(res["seconds"]) == ["A", "B", "C", "D"]
    assert len(res["losses"]) == 2
    assert all(np.isfinite(list(d.values())).all() for d in res["losses"])
    assert res["infer_stats"]["n_images"] == 3
    s = res["summary"]
    assert len(s["easy_tier"]["rank_per_image"]) == len(s["hard_tier"]["rank_per_image"]) == 3
    assert s["candidates_per_image"] == 60 and s["chance_R@10_pct"] == 16.7
    assert isinstance(res["ok"], bool)
    for name in ("segmenter.pt", "openset_cfg.py", "train_cfg.py", "psg.json"):
        assert os.path.exists(os.path.join(os.path.dirname(res["ann"]), name))


def test_extended_config_restores_the_checkpoint_unchanged(res):
    from openpsg_tpu_torch.core.builder import build_detector_from_config
    from openpsg_tpu_torch.core.config import Config
    from openpsg_tpu_torch.train.checkpoint import restore_trainable_for_inference

    cfg = Config.fromfile(res["ext_cfg"])
    model = build_detector_from_config(cfg, seed=1, device="cpu")
    assert model.relation_names == so.TRAIN_NAMES + [so.HELD_OUT, so.HELD_OUT_HARD]
    step, meta = restore_trainable_for_inference(model, cfg, res["ckpt_dir"])
    assert step == 3 and meta["epoch"] == 1
    trained = res["pipeline"]
    for g in ("segmenter", "head", "object_cls_embed"):
        want = trained.param_groups()[g]
        got = model.param_groups()[g]
        assert set(got) == set(want), g
        assert all(torch.equal(got[n], want[n]) for n in want), g


def test_token_overlaps_equal_jax(res):
    from openpsg_tpu.models.relation.tokenizer import build_prompt_tokenizer

    ptok = build_prompt_tokenizer()
    train_tok = {t for n in so.TRAIN_NAMES for t in ptok.encode(n)}
    want = {name: sorted(set(ptok.encode(name)) & train_tok)
            for name in (so.HELD_OUT, so.HELD_OUT_HARD)}
    assert res["overlap"] == want
    assert want[so.HELD_OUT] and not want[so.HELD_OUT_HARD]


def test_per_predicate_table_has_the_held_out_ids(res):
    for k in (10, 20):
        assert set(res["scores"][f"perR@{k}"]) == {so.TRAIN_NAMES.index("looking at"),
                                                   so.HELDOUT_ID, so.HELDOUT_HARD_ID}


@pytest.mark.parametrize("n", [3, 400])
def test_learning_rate_equals_optax(n):
    import optax

    want = optax.cosine_decay_schedule(2e-3, n, 0.05)
    got = so.lr_schedule(n)
    for count in (0, 1, n // 2, n - 1, n, n + 7):
        assert np.float32(got(count)) == np.float32(want(count)), count


def test_defaults_to_the_card():
    assert so.parse_args([]).device == "cuda" and so.parse_args([]).rel_steps == 400
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        so.run("unused", device="cuda")
