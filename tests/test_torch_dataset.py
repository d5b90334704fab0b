"""The port's PSG dataset (openpsg_tpu_torch.data.psg_dataset) against the
JAX package's on ``tests/fixtures.make_fixture``: examples bit-identical
(flip 0.5 and scale jitter drawn from the same generator, over 3 seeds),
the mask extraction bit-identical to the JAX package's native codec, and
the split, filter and small-set cases of tests/test_dataset.py."""

import json
import os

import numpy as np
import pytest
import torch

from fixtures import make_fixture
from openpsg_tpu import native
from openpsg_tpu.data.preprocess import Preprocessor as JaxPreprocessor
from openpsg_tpu.data.psg_dataset import PSGDataset as JaxPSGDataset
from openpsg_tpu_torch.data.preprocess import Preprocessor
from openpsg_tpu_torch.data.psg_dataset import PSGDataset
from openpsg_tpu_torch.utils.panoptic import extract_masks_downsampled

# the suite's workers share the cores, and these tensors are tiny: one torch
# thread each, not a pool per worker spinning against the others
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def fixture_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("psg")
    make_fixture(str(root), n_images=4, hw=[(96, 64), (64, 80)])
    return str(root)


def _both(root, **kw):
    ann = os.path.join(root, "psg.json")
    return (PSGDataset(ann, img_prefix=root, seg_prefix=root, **kw),
            JaxPSGDataset(ann, img_prefix=root, seg_prefix=root, **kw))


def _same(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if k == "image_id":
            assert a[k] == b[k]
            continue
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_iter_train_bit_identical(fixture_root, seed):
    ds, jds = _both(fixture_root, split="train")
    kw = dict(max_objects=8, batch_size=1, seed=seed, flip_prob=0.5, scale_jitter=(24, 60),
              epochs=3)
    got = list(ds.iter_train(Preprocessor(scale=(64, 64)), **kw))
    want = list(jds.iter_train(JaxPreprocessor(scale=(64, 64)), **kw))
    assert len(got) == len(want) == 6
    for a, b in zip(got, want):
        _same(a[0], b[0])
    shapes = {tuple(e[0]["img_shape"]) for e in got}
    assert len(shapes) > 1, shapes                        # the jitter moved the scale


def test_load_example_content(fixture_root):
    ds, jds = _both(fixture_root, split="train")
    ex = ds.load_example(0, Preprocessor(scale=(64, 64)), max_objects=8)
    _same(ex, jds.load_example(0, JaxPreprocessor(scale=(64, 64)), max_objects=8))
    assert ex["object_valid"][:3].all() and not ex["object_valid"][3:].any()
    np.testing.assert_array_equal(ex["object_labels"][:3], [0, 16, 119])
    assert ex["relation_target"][0, 2, 4] == 1 and ex["relation_target"].sum() == 2


@pytest.mark.parametrize("case", ["random", "repeated ids", "upscale", "no segments"])
def test_extract_masks_matches_native(case):
    rng = np.random.default_rng(4)
    ids = rng.integers(0, 5, (37, 23)).astype(np.int32)
    seg, out = [0, 2, 3, 9], (9, 6)
    if case == "repeated ids":
        seg = [2, 1, 2, 4]
    elif case == "upscale":
        out = (50, 31)
    elif case == "no segments":
        seg = []
    got = extract_masks_downsampled(ids, seg, out)
    want = native.extract_masks_downsampled(ids, seg, out)
    assert got.dtype == want.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    if case == "random":   # the JAX numpy fallback agrees too
        np.testing.assert_array_equal(got, native._np_masks(ids, np.asarray(seg, np.int32), out))


def test_split_semantics(fixture_root):
    ann = os.path.join(fixture_root, "psg.json")
    for split in ("train", "val", "test"):
        got, want = PSGDataset(ann, split=split), JaxPSGDataset(ann, split=split)
        assert [r.__dict__ for r in got.records] == [r.__dict__ for r in want.records]
        assert len(got) == 2
    train, test = PSGDataset(ann, split="train"), PSGDataset(ann, split="test")
    assert not {r.image_id for r in train.records} & {r.image_id for r in test.records}


def test_filter_no_relation(fixture_root, tmp_path):
    with open(os.path.join(fixture_root, "psg.json")) as f:
        raw = json.load(f)
    raw["data"][3]["relations"] = []
    p = str(tmp_path / "norel.json")
    with open(p, "w") as f:
        json.dump(raw, f)
    got = PSGDataset(p, split="test", filter_no_relation=True)
    want = JaxPSGDataset(p, split="test", filter_no_relation=True)
    assert len(got) == len(want) == 1
    assert got.records[0].image_id == want.records[0].image_id


def test_coco_panoptic_layout(tmp_path):
    raw = {
        "images": [{"id": 5, "file_name": "a.jpg", "height": 10, "width": 12}],
        "annotations": [{"image_id": 5, "file_name": "a.png",
                         "segments_info": [{"id": 1, "category_id": 40},
                                           {"id": 2, "category_id": 7}]}],
        "categories": [{"id": 7, "isthing": 1}, {"id": 40, "isthing": 0}],
        "relations": {"5": [[0, 1, 3]]},
    }
    p = str(tmp_path / "coco.json")
    with open(p, "w") as f:
        json.dump(raw, f)
    got, want = PSGDataset(p), JaxPSGDataset(p)
    assert [r.__dict__ for r in got.records] == [r.__dict__ for r in want.records]
    assert got.records[0].segments_info[0] == {"id": 1, "category": 1, "is_thing": False}
    with open(p, "w") as f:
        json.dump({"neither": []}, f)
    with pytest.raises(ValueError, match="unrecognized"):
        PSGDataset(p)


def test_small_dataset_still_yields_a_batch(fixture_root):
    ds, jds = _both(fixture_root, split="train")
    got = list(ds.iter_train(Preprocessor(scale=(64, 64)), 8, batch_size=5, seed=0))
    want = list(jds.iter_train(JaxPreprocessor(scale=(64, 64)), 8, batch_size=5, seed=0))
    assert len(got) == len(want) == 1 and len(got[0]) == 5
    for a, b in zip(got[0], want[0]):
        _same(a, b)
