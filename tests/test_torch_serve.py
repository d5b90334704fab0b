"""The port's server (``openpsg_tpu_torch.tools.serve``) against the JAX
package's ``tools/serve.py`` on bridged tiny weights.

One model pair: the JAX builder's model from ``configs/psg/tiny_v4_ov.py``
at ``input_hw=(128, 128)``, and the port builder's from its copy with the
JAX weights bridged.  The JAX ``InferenceService`` and ``_record_for`` run
the JAX model in-process; the port's server answers over a real socket.
Records must be equal: relations, segments_info and object_id_list
exactly, relation scores within TOL, and the decoded PNG pixels exactly
(the PNG bytes come from different encoders).
"""

import base64
import contextlib
import dataclasses
import http.client
import json
import os
import pathlib
import sys
import threading
from concurrent.futures import ThreadPoolExecutor

import cv2
import jax
import numpy as np
import pytest
import torch

from openpsg_tpu_torch.bridge import load_jax_params
from openpsg_tpu_torch.tools import serve

# the suite's workers share the cores, and these tensors are tiny: one torch
# thread each, not a pool per worker spinning against the others
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HWS = [(128, 96), (96, 128)]   # the keep-ratio resize into 128² is the identity
TOL = dict(rtol=0, atol=1e-5)  # relation scores: the same float32 arithmetic
                               # in another order


def _jax_serve():
    sys.path.insert(0, os.path.join(REPO, "tools"))
    try:
        import serve as jax_serve
    finally:
        sys.path.pop(0)
    return jax_serve


def _tree(jp):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(jp.params))


def _pair(tmp, name, extra):
    """(JAX model, bridged port model, port config path) for a tiny config.
    The configs leave iou_thr at 0.8; 0.1 keeps several objects of the tiny
    random models (set before the JAX program is first traced)."""
    from openpsg_tpu.core.builder import build_detector_from_config as jax_build
    from openpsg_tpu.core.config import Config as JaxConfig

    from openpsg_tpu_torch.core.builder import build_detector_from_config
    from openpsg_tpu_torch.core.config import Config

    cfgs = {}
    for side, base in (("jax", "configs/psg"), ("port", "openpsg_tpu_torch/configs/psg")):
        cfgs[side] = tmp / f"{side}_{name}"
        cfgs[side].write_text(f"_base_ = ['{REPO}/{base}/{name}']\n" + extra)
    jp = jax_build(JaxConfig.fromfile(str(cfgs["jax"])), jax.random.PRNGKey(0))
    model = build_detector_from_config(Config.fromfile(str(cfgs["port"])), seed=0, device="cpu")
    load_jax_params(model, _tree(jp))
    jp.cfg = dataclasses.replace(jp.cfg, iou_thr=0.1)
    model.cfg = dataclasses.replace(model.cfg, iou_thr=0.1)
    return jp, model, str(cfgs["port"])


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    from tests.fixtures import make_fixture

    tmp = tmp_path_factory.mktemp("serve")
    root = tmp / "psg"
    make_fixture(str(root), n_images=2, hw=HWS)
    jp, model, cfg = _pair(tmp, "tiny_v4_ov.py", "tpu = dict(input_hw=(128, 128))\n")
    paths = [str(root / "images" / f"{i}.jpg") for i in range(len(HWS))]
    bodies = [pathlib.Path(p).read_bytes() for p in paths]
    rgbs = [cv2.imread(p)[..., ::-1].copy() for p in paths]
    s = dict(tmp=tmp, jp=jp, model=model, cfg=cfg, bodies=bodies, rgbs=rgbs, jax={})
    # the JAX service's records, in a thread while the port's server is tested
    s["jax"] = ThreadPoolExecutor(1).submit(
        lambda: {key: _jax_service_records(s, **kw) for key, kw in JAX_RECORDS.items()})
    return s


def _argv(cfg, *extra):
    return ["--config", cfg, "--port", "0", "--img-scale", "128", "128", "--single-bucket",
            "--device", "cpu"] + list(extra)


@contextlib.contextmanager
def serving(argv, model):
    httpd, service = serve.make_server(serve.parse_args(argv), model=model)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    try:
        yield httpd.server_address[:2], service
    finally:
        httpd.shutdown()
        service.stop()
        httpd.server_close()


def _request(addr, method, path, body=None):
    conn = http.client.HTTPConnection(*addr, timeout=600)
    conn.request(method, path, body=body)
    resp = conn.getresponse()
    out = resp.status, json.loads(resp.read())
    conn.close()
    return out


def _post_many(addr, bodies):
    """POST each body from its own thread, all at once → [(status, record)]."""
    out = [None] * len(bodies)

    def hit(i):
        out[i] = _request(addr, "POST", "/infer", bodies[i])

    ts = [threading.Thread(target=hit, args=(i,)) for i in range(len(bodies))]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=600)
    return out


def _pixels(rec):
    return cv2.imdecode(np.frombuffer(base64.b64decode(rec["pan_seg_png"]), np.uint8),
                        cv2.IMREAD_COLOR)


def assert_same_record(got, want, hw):
    got = dict(got)
    got.pop("latency_ms", None)
    assert set(got) == set(want)
    for key in ("relations", "segments_info", "object_id_list"):
        assert got[key] == want[key], key
    np.testing.assert_allclose(got["relation_scores"], want["relation_scores"], **TOL)
    a, b = _pixels(got), _pixels(want)
    assert a.shape[:2] == tuple(hw)
    np.testing.assert_array_equal(a, b)


def _jax_service(s, **kw):
    from openpsg_tpu.data.preprocess import Preprocessor

    return _jax_serve().InferenceService(s["jp"], Preprocessor(scale=(128, 128)), **kw)


# the JAX records the tests hold the port to: per image, one micro-batch
# group padded to 3, and image 0 at trip budgets 2 and 0
JAX_RECORDS = {"per_image": {}, "mb": dict(micro_batch=True), "budget2": dict(budget=2, n=1),
               "budget0": dict(budget=0, n=1)}


def _jax_service_records(s, budget=None, micro_batch=False, n=len(HWS)):
    """The JAX service's records for the first ``n`` fixture images: one
    image per call, or (``micro_batch``) all in one group padded to 3."""
    jax_serve = _jax_serve()
    s["jp"].decode_trip_budget = budget
    svc = _jax_service(s, batch_size=3 if micro_batch else 1, micro_batch=micro_batch)
    try:
        if micro_batch:
            jobs = [svc._make_job(rgb) for rgb in s["rgbs"][:n]]
            svc._run_group(jobs)
            assert all(j.error is None for j in jobs)
            pairs = [(j.result, j.ex) for j in jobs]
        else:
            pairs = [svc.submit(rgb) for rgb in s["rgbs"][:n]]
    finally:
        svc.stop()
        s["jp"].decode_trip_budget = None
    return [jax_serve._record_for(res, ex, 0) for res, ex in pairs]


def jax_records(s, key):
    """The JAX records of :data:`JAX_RECORDS`' ``key`` (waits for them)."""
    return s["jax"].result()[key]


@pytest.fixture(scope="module")
def server(setup):
    """The port's server at batch size 2 (``infer_batch``), warmed up."""
    with serving(_argv(setup["cfg"], "--batch-size", "2", "--max-wait-ms", "1000"),
                 setup["model"]) as (addr, service):
        service.warmup()
        yield addr, service


def test_per_image_records_equal_jax(setup, server):
    addr, _ = server
    want = jax_records(setup, "per_image")
    for body, rec, hw in zip(setup["bodies"], want, HWS):
        status, got = _request(addr, "POST", "/infer", body)
        assert status == 200
        assert all(r >= 1 for _, _, r in got["relations"])
        assert_same_record(got, rec, hw)
    assert sum(len(r["segments_info"]) for r in want) >= 2


@contextlib.contextmanager
def group_sizes(model, name):
    """Record the image count of each call of ``model.<name>``."""
    sizes, real = [], getattr(model, name)

    def wrapped(images, *a, **kw):
        sizes.append(len(images))
        return real(images, *a, **kw)

    setattr(model, name, wrapped)
    try:
        yield sizes
    finally:
        delattr(model, name)


def test_group_of_two_in_batch_mode(setup, server):
    addr, _ = server
    with group_sizes(setup["model"], "infer_batch") as sizes:
        out = _post_many(addr, setup["bodies"])
    assert sizes == [2]
    # the JAX package's batched program equals its per-image one
    for (status, got), rec, hw in zip(out, jax_records(setup, "per_image"), HWS):
        assert status == 200
        assert_same_record(got, rec, hw)


def test_group_of_two_with_micro_batch_and_one_pad(setup):
    argv = _argv(setup["cfg"], "--batch-size", "3", "--micro-batch", "--max-wait-ms", "1000")
    with serving(argv, setup["model"]) as (addr, service):
        assert service.micro_batch
        with group_sizes(setup["model"], "infer_microbatch") as sizes:
            out = _post_many(addr, setup["bodies"])
    assert sizes == [3]
    for (status, got), rec, hw in zip(out, jax_records(setup, "mb"), HWS):
        assert status == 200
        assert_same_record(got, rec, hw)


def test_concurrent_identical_posts(setup, server):
    addr, _ = server
    out = _post_many(addr, [setup["bodies"][0]] * 2)
    recs = []
    for status, rec in out:
        assert status == 200
        assert "latency_ms" in rec
        rec.pop("latency_ms")
        recs.append(rec)
    assert recs[0] == recs[1]


def test_trip_budget_is_a_runtime_argument(setup, server):
    """Budget 2, then None on the same service with no rebuild; then 0,
    which is zero trips in the port and uncapped in the JAX package (F1)."""
    addr, service = server
    model = service.model
    try:
        service.trip_budget = 2
        status, got = _request(addr, "POST", "/infer", setup["bodies"][0])
        assert status == 200
        assert_same_record(got, jax_records(setup, "budget2")[0], HWS[0])
        res, _ = service.submit(setup["rgbs"][0])
        assert res["decode_steps"] <= 2
        service.trip_budget = None
        assert service.model is model
        status, got = _request(addr, "POST", "/infer", setup["bodies"][0])
        assert status == 200
        assert_same_record(got, jax_records(setup, "per_image")[0], HWS[0])
        service.trip_budget = 0
        res, _ = service.submit(setup["rgbs"][0])
        assert res["decode_steps"] == 0
    finally:
        service.trip_budget = None
    assert jax_records(setup, "budget0") == jax_records(setup, "per_image")[:1]


def test_healthz_and_unknown_paths(server):
    addr, _ = server
    status, obj = _request(addr, "GET", "/healthz")
    assert status == 200
    assert obj == dict(status="ok", device="cpu", buckets=[[128, 128]], batch_size=2)
    assert _request(addr, "GET", "/nope")[0] == 404
    assert _request(addr, "POST", "/nope", b"x")[0] == 404


def test_undecodable_bodies_give_400(setup, server, monkeypatch):
    addr, _ = server
    assert _request(addr, "POST", "/infer", b"not an image") == (
        400, {"error": "undecodable image"})
    # without cv2 the server reads PNG only: a JPEG is refused, a PNG served
    monkeypatch.setattr(serve, "_cv2", lambda: None)
    assert _request(addr, "POST", "/infer", setup["bodies"][0])[0] == 400
    ok, png = cv2.imencode(".png", setup["rgbs"][0][..., ::-1])
    status, got = _request(addr, "POST", "/infer", png.tobytes())
    assert ok and status == 200
    assert _pixels(got).shape[:2] == HWS[0]


def test_cancelled_job_is_dropped(setup, server):
    _, service = server
    dead, live = (service._make_job(rgb) for rgb in setup["rgbs"])
    dead.cancelled = True
    with group_sizes(setup["model"], "infer_microbatch") as sizes:
        service.queue.put(dead)
        service.queue.put(live)
        assert live.event.wait(600)
    assert sizes == [1] and live.error is None and live.result is not None
    assert not dead.event.is_set() and dead.result is None


def test_device_loop_runs_in_inference_mode(setup, server):
    """Grad mode is per thread: the loop must turn it off itself, or the
    card's attention kernel refuses inputs that need a gradient."""
    addr, _ = server
    seen = []
    real = setup["model"].tail_pre

    def tail_pre(*a, **kw):
        seen.append((torch.is_inference_mode_enabled(), torch.is_grad_enabled()))
        out = real(*a, **kw)
        tensors = [out[1], out[2]] + [v for v in out[0].values()
                                      if isinstance(v, torch.Tensor)]
        seen.append(any(t.requires_grad for t in tensors))
        return out

    assert torch.is_grad_enabled()
    setup["model"].tail_pre = tail_pre
    try:
        assert _request(addr, "POST", "/infer", setup["bodies"][1])[0] == 200
    finally:
        del setup["model"].tail_pre
    assert seen == [(True, False), False]


def test_make_server_defaults_to_the_card(setup):
    args = serve.parse_args(["--config", setup["cfg"]])
    assert args.device == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.make_server(args)


def test_family_model_record_equals_jax(setup):
    """A closed-set family model (``tiny_r50.py``) is served through
    ``infer`` like PSG v4."""
    from openpsg_tpu.data.preprocess import Preprocessor

    keep = "model = dict(test_cfg=dict(object_mask_thr=0.0))\n"
    jp, model, cfg = _pair(setup["tmp"], "tiny_r50.py", keep)
    jax_serve = _jax_serve()
    svc = jax_serve.InferenceService(jp, Preprocessor(scale=(64, 64)))
    try:
        want = jax_serve._record_for(*svc.submit(setup["rgbs"][0]), 0)
    finally:
        svc.stop()
    argv = ["--config", cfg, "--port", "0", "--img-scale", "64", "64", "--single-bucket",
            "--device", "cpu"]
    with serving(argv, model) as (addr, _):
        status, got = _request(addr, "POST", "/infer", setup["bodies"][0])
    assert status == 200
    assert_same_record(got, want, HWS[0])
    assert want["segments_info"] and want["relations"]
