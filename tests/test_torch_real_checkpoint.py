"""The port's checkout against the PUBLISHED OpenSeeD checkpoint (twin of
tests/test_real_checkpoint.py, gated on the same variables):

    OPENPSG_REAL_CKPT=/path/model_state_dict_swint_51.2ap.pt \\
    [OPENPSG_CLIP_MERGES=/path/bpe_simple_vocab_16e6.txt.gz] \\
    [OPENPSG_REF_BUNDLE=/path/dir_with_input.npy+pan_ref.npy+mf_ref.npy] \\
        python -m pytest tests/test_torch_real_checkpoint.py -q

The port's ``convert_openseed`` tool converts the checkpoint (strict: an
unmapped key fails the run), ``PSGv4.load_segmenter_weights`` loads the
result, and the segmenter runs on the card when there is one, else on the
CPU.  Without ``OPENPSG_REAL_CKPT`` every test skips: the weights are not
in the repository.
"""

from __future__ import annotations

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

# the suite's workers share the cores, and these tensors are tiny: one torch
# thread each, not a pool per worker spinning against the others
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.environ.get("OPENPSG_REAL_CKPT", "")
BUNDLE = os.environ.get("OPENPSG_REF_BUNDLE", "")

pytestmark = pytest.mark.skipif(
    not (CKPT and os.path.exists(CKPT)),
    reason="set OPENPSG_REAL_CKPT to the published OpenSeeD .pt to run the port's "
    "real-checkpoint checkout",
)


def _device():
    import torch

    return "cuda" if torch.cuda.is_available() else "cpu"


@pytest.fixture(scope="module")
def converted(tmp_path_factory):
    out = tmp_path_factory.mktemp("openseed_port")
    cmd = [sys.executable, "-m", "openpsg_tpu_torch.tools.convert_openseed", CKPT,
           "--out", str(out), "--device", _device()]
    merges = os.environ.get("OPENPSG_CLIP_MERGES")
    if merges:
        cmd += ["--merges", merges]
    res = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=1800)
    assert res.returncode == 0, res.stderr[-4000:]
    assert (out / "segmenter.pt").exists() and (out / "lang.pt").exists()
    return out, res.stdout


def test_conversion_report_level_strides(converted):
    """Stride 8/16/32 input projections are 1x1 convolutions from the
    Swin-T stage widths (192/384/768)."""
    _, report = converted
    assert "level" in report and "stride" in report, report[-2000:]
    for width in ("192", "384", "768"):
        assert width in report, f"stage width {width} missing:\n{report}"


@pytest.fixture(scope="module")
def model(converted):
    from openpsg_tpu_torch.models.detectors.psg_v4 import PSGv4, PSGv4Config
    from openpsg_tpu_torch.models.segmenter.openseed import SegmenterConfig

    out, _ = converted
    emb = out / "class_embeds.npy"
    m = PSGv4(PSGv4Config(segmenter=SegmenterConfig()), seed=0, device=_device(),
              precomputed_class_embeds=str(emb) if emb.exists() else None)
    m.load_segmenter_weights(str(out / "segmenter.pt"))
    return m


def _segment(model, img):
    import torch

    with torch.no_grad():
        seg = model.segment(torch.as_tensor(img).to(model.device))
    return {k: v.float().cpu().numpy() for k, v in seg.items()}


def test_smoke_forward_finite(model):
    """Finite, non-degenerate segmenter output, and a confident query."""
    img = np.random.default_rng(0).integers(0, 255, (512, 512, 3)).astype(np.uint8)
    seg = _segment(model, img)
    mf = seg["mask_features"]
    assert np.isfinite(mf).all() and mf.std() > 1e-3, "mask_features collapsed"
    logits = seg["cls_logits"]
    assert np.isfinite(logits).all()
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    assert probs.max() > 0.5, "no confident query: suspect the conversion"


needs_bundle = pytest.mark.skipif(
    not (BUNDLE and os.path.exists(os.path.join(BUNDLE, "input.npy"))),
    reason="set OPENPSG_REF_BUNDLE to the dir holding input.npy / pan_ref.npy / mf_ref.npy",
)


def _bundle_image():
    img = np.load(os.path.join(BUNDLE, "input.npy"))
    return img.transpose(1, 2, 0) if img.shape[0] == 3 else img


@needs_bundle
def test_mask_features_cosine(model):
    mf = _segment(model, _bundle_image().astype(np.uint8))["mask_features"]
    mf_ref = np.load(os.path.join(BUNDLE, "mf_ref.npy")).astype(np.float32)
    if mf_ref.shape[0] == mf.shape[-1]:        # CHW → HWC
        mf_ref = mf_ref.transpose(1, 2, 0)
    assert mf.shape == mf_ref.shape, (mf.shape, mf_ref.shape)
    cos = float((mf * mf_ref).sum() / (np.linalg.norm(mf) * np.linalg.norm(mf_ref) + 1e-12))
    assert cos > 0.99, f"mask_features cosine {cos:.4f} <= 0.99"


@needs_bundle
def test_panoptic_agreement(model):
    img = _bundle_image()
    pan = np.asarray(model.infer(img.astype(np.uint8), img.shape[:2])["pan_results"])
    pan_ref = np.load(os.path.join(BUNDLE, "pan_ref.npy"))
    assert pan.shape == pan_ref.shape, (pan.shape, pan_ref.shape)
    valid = pan_ref != 133
    agree = float((pan % 1000 == pan_ref % 1000)[valid].mean())
    assert agree > 0.97, f"pixel category agreement {agree:.4f} <= 0.97"
