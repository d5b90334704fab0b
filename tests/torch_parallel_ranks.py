"""Rank programs of the port's parallel tests (``tests/test_torch_parallel_*.py``),
started by ``openpsg_tpu_torch.parallel.launch.spawn``: each runs on one
gloo rank on the CPU, builds its model from a state file the test wrote,
and returns numpy arrays for the test to hold against the JAX package.
Imports torch only."""

import numpy as np
import torch

from openpsg_tpu_torch.models.llm.decode import greedy_decode
from openpsg_tpu_torch.models.llm.llama import LlamaConfig, LlamaWithEmbeddings
from openpsg_tpu_torch.parallel.mesh import make_mesh
from openpsg_tpu_torch.parallel.sharding import assert_llm_sharded, shard_params


def _llm(cfg_kw, state_path):
    cfg = LlamaConfig(**cfg_kw)
    llm = LlamaWithEmbeddings(cfg)
    llm.load_state_dict(torch.load(state_path), strict=True)
    return llm.eval().requires_grad_(False)


def llm_suite(tasks):
    """Several cases in one rank group: [(function name, args), ...] →
    their results, in order."""
    return [globals()[name](*args) for name, args in tasks]


def llm_tp(cfg_kw, state_path, inputs, tp, decode_steps=0, eos_id=-1):
    """The LLM tp-sharded over all ranks (dp 1): logits of a cache-free
    forward, and greedy tokens when ``decode_steps``."""
    llm = _llm(cfg_kw, state_path)
    mesh = make_mesh(dp=None, tp=tp)
    shard_params(llm, mesh)
    out = {"n_sharded": assert_llm_sharded(llm, mesh, min_sharded=1)}
    emb, mask, pos = (torch.from_numpy(inputs[k]) for k in ("embeds", "mask", "positions"))
    if not cfg_kw["quant"]:
        # every float parameter trainable: the gradients of a scalar of the
        # logits, whole, against the unsharded LLM's on the same rank
        from openpsg_tpu_torch.parallel.sharding import full_tensors

        ref = _llm(cfg_kw, state_path).requires_grad_(True)
        llm.requires_grad_(True)
        for m in (ref, llm):
            lg = m(input_embeds=emb, attention_mask=mask, positions=pos.long())[0]
            (lg.square().mean() + m.embed(torch.from_numpy(inputs["ids"]).long()).sum()).backward()
        got = full_tensors(llm, {n: p.grad for n, p in llm.named_parameters()})
        out["grad_err"] = max(float((got[n] - p.grad).abs().max() / p.grad.abs().max())
                              for n, p in ref.named_parameters())
        llm.requires_grad_(False)
    with torch.no_grad():
        out["logits"] = llm(input_embeds=emb, attention_mask=mask, positions=pos.long())[0].numpy()
        out["embed"] = llm.embed(torch.from_numpy(inputs["ids"]).long()).numpy()
        if decode_steps:
            toks, scores, trips = greedy_decode(llm, emb, mask, decode_steps, eos_id=eos_id)
            out.update(tokens=toks.numpy(), scores=scores.numpy(), trips=trips)
    return out


def llm_pipeline(cfg_kw, state_path, inputs, pp, dp, tp, n_micro, last_logit_only=False,
                 remat=False, grads=False):
    """The LLM cut into pp stages (tp inside each) on a dp×pp(×tp) mesh; each
    dp rank runs its block of the rows → its logits and, with ``grads``,
    the gradients of a mean log-likelihood over ALL rows (summed over dp)
    for the input embeddings and every parameter this rank holds (whole
    tensors: tp blocks gathered)."""
    from openpsg_tpu_torch.parallel.comm import all_reduce
    from openpsg_tpu_torch.parallel.mesh import axis_group
    from openpsg_tpu_torch.parallel.pipeline import (
        make_dp_pp_mesh,
        pipelined_llama_logits,
        shard_pipeline,
    )
    from openpsg_tpu_torch.parallel.sharding import full_tensors

    llm = _llm(cfg_kw, state_path)
    mesh = make_dp_pp_mesh(pp=pp, dp=dp, tp=tp)
    shard_pipeline(llm, mesh)
    dgroup, d, ndp = axis_group(mesh, "dp")
    B = inputs["embeds"].shape[0]
    rows = slice(d * B // ndp, (d + 1) * B // ndp)
    emb = torch.from_numpy(inputs["embeds"][rows]).requires_grad_(grads)
    mask = torch.from_numpy(inputs["mask"][rows])
    pos = torch.from_numpy(inputs["positions"][rows]).long()
    if grads:
        llm.requires_grad_(True)
    with torch.set_grad_enabled(grads):
        logits = pipelined_llama_logits(llm, emb, mask, pos, mesh, n_micro,
                                        last_logit_only=last_logit_only, remat=remat)
    out = {"rows": (rows.start, rows.stop), "logits": logits.detach().numpy()}
    if grads:
        tgt = torch.from_numpy(inputs["targets"][rows]).long()
        lp = torch.log_softmax(logits, -1).gather(-1, tgt[..., None])
        loss = -lp.sum() / inputs["targets"].size
        loss.backward()
        out["emb_grad"] = emb.grad.numpy()
        g = {n: all_reduce(torch.zeros_like(p) if p.grad is None else p.grad, "sum", dgroup)
             for n, p in llm.named_parameters()}
        out["grads"] = {n: v.numpy() for n, v in full_tensors(llm, g).items()}
    return out


# ---------------------------------------------------------------- PSG v4
def _v4(state_path, cfg_path=None, **overrides):
    """The tiny PSG v4 model (config fields ``overrides``; or the builder's
    model of ``cfg_path``) with the weights the test saved (the JAX
    model's, bridged)."""
    import dataclasses

    from openpsg_tpu_torch.core.builder import build_detector_from_config
    from openpsg_tpu_torch.core.config import Config
    from openpsg_tpu_torch.models.detectors.psg_v4 import PSGv4, PSGv4Config

    if cfg_path:
        model = build_detector_from_config(Config.fromfile(cfg_path), seed=0, device="cpu")
    else:
        model = PSGv4(dataclasses.replace(PSGv4Config.tiny_test(), **overrides), seed=0,
                      device="cpu")
    state = torch.load(state_path)
    for part in ("segmenter", "head", "llm", "text"):
        getattr(model, part).load_state_dict(state[part], strict=True)
    model.class_embeds = state["class_embeds"]
    return model


def v4_infer(state_path, images, hws, overrides):
    """dp infer_batch over all ranks, the pair-sharded single image (with
    the Q-Former's pair count recorded), then infer_batch on a dp×tp mesh
    with the LLM tp-sharded."""
    import torch.distributed as dist

    world = dist.get_world_size()
    model = _v4(state_path, **overrides)
    mesh = make_mesh(dp=world, tp=1)
    out = {"batch": model.infer_batch(images, hws, mesh=mesh)}
    seen = []
    hook = model.head.qformer.register_forward_hook(
        lambda m, a, o: seen.append(int(a[0].shape[0])))
    out["pair"] = model.make_pair_sharded_infer(mesh)(images[0], hws[0])
    hook.remove()
    out["pair_np"] = seen
    mesh2 = make_mesh(dp=world // 2, tp=2)
    shard_params(model.llm, mesh2)
    out["batch_tp"] = model.infer_batch(images[:world], hws[:world], mesh=mesh2)
    return out


def family_infer(cfg_path, images, hws):
    """The closed-set family's infer_batch over a dp mesh of every rank, and
    (rank 0) per-image infer."""
    import dataclasses

    import torch.distributed as dist

    from openpsg_tpu_torch.core.builder import build_detector_from_config
    from openpsg_tpu_torch.core.config import Config

    model = build_detector_from_config(Config.fromfile(cfg_path), seed=0, device="cpu")
    model.cfg = dataclasses.replace(model.cfg, iou_thr=0.1)
    out = {"batch": model.infer_batch(images, hws,
                                      mesh=make_mesh(dp=dist.get_world_size(), tp=1))}
    if dist.get_rank() == 0:
        out["single"] = [model.infer(i, h) for i, h in zip(images, hws)]
    return out


def serve_dp(state_path, argv, bodies, idle_s, collective_s, rdzv):
    """The port's server on every rank: rank 0 through
    ``tools.serve.make_server``, serving over HTTP and posting ``bodies``
    to itself (image 0 alone; images 0 and 1 at once; the same pair again,
    whose block on rank 1 raises; after ``idle_s`` idle seconds images 1
    and 2 at once; then at batch size 4 images 0-2 at once: a padded
    tail); the other ranks through ``tools.serve.main``, following until
    rank 0's ``stop()``.  The process group is formed anew first (file
    rendezvous ``rdzv``) with a collective timeout of ``collective_s``, so
    the idle wait outlasts it.  → the mesh each built, and rank 0's
    records and group sizes or a follower's count of groups."""
    import datetime
    import http.client
    import json
    import threading
    import time

    import torch.distributed as dist

    from openpsg_tpu_torch.tools import serve

    rank, world = dist.get_rank(), dist.get_world_size()
    dist.destroy_process_group()
    dist.init_process_group("gloo", init_method="file://" + rdzv, rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=collective_s))
    model = _v4(state_path, iou_thr=0.1)

    def mesh_dims(mesh):
        return None if mesh is None else dict(zip(mesh.mesh_dim_names, mesh.shape))

    if rank != 0:   # the tool's own entry point
        infers, infer = [], model.infer

        def failing_second(*a, **k):   # this rank's block of the third group
            infers.append(1)
            if len(infers) == 2:
                raise ValueError("the follower's block fails")
            return infer(*a, **k)

        model.infer = failing_second
        ran, run = [], serve.Follower.run
        serve.Follower.run = lambda self: ran.append((mesh_dims(self.mesh), run(self)))
        serve.main(argv, model=model)
        return {"mesh": ran[0][0], "groups": ran[0][1]}
    httpd, svc = serve.make_server(serve.parse_args(argv), model=model)
    out = {"mesh": mesh_dims(svc.mesh)}
    calls, real = [], model.infer_batch     # the groups: a group of one runs infer
    model.infer_batch = lambda imgs, *a, **k: calls.append(len(imgs)) or real(imgs, *a, **k)

    def post(i, res, k):
        conn = http.client.HTTPConnection(*httpd.server_address[:2], timeout=300)
        conn.request("POST", "/infer", body=bodies[i])
        resp = conn.getresponse()
        res[k] = (resp.status, json.loads(resp.read()))
        conn.close()

    def post_many(idx):
        res = [None] * len(idx)
        ts = [threading.Thread(target=post, args=(i, res, k)) for k, i in enumerate(idx)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=300)
        return res

    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        out["single"] = post_many([0])
        out["pair"] = post_many([0, 1])
        out["failed"] = post_many([0, 1])
        time.sleep(idle_s)
        out["after_idle"] = post_many([1, 2])
        svc.batch_size = 4
        out["tail"] = post_many([0, 1, 2])
    finally:
        httpd.shutdown()
        svc.stop()
        httpd.server_close()
    out["calls"] = calls
    return out


def v4_train(state_path, arrays, trainable, dp, tp):
    """One dp×tp train step's gradients on this rank's rows of the global
    batch → the dp-mean losses, the global norm, the gradients as whole
    tensors, and the counts of tp-split parameters and AdamW moments."""
    from openpsg_tpu_torch.parallel.mesh import axis_group
    from openpsg_tpu_torch.train.trainer import (
        TrainBatch,
        V4Trainer,
        make_lr_schedule,
        make_optimizer,
    )

    model = _v4(state_path)
    mesh = make_mesh(dp=dp, tp=tp)
    shard_params(model.llm, mesh)
    _, d, _ = axis_group(mesh, "dp")
    B = len(arrays["image"]) // dp
    batch = TrainBatch.from_numpy({k: v[d * B:(d + 1) * B] for k, v in arrays.items()}, "cpu")
    tr = V4Trainer(model, trainable=tuple(trainable), mesh=mesh)
    out = {"llm_sharded": assert_llm_sharded(model.llm, mesh)}
    if "llm" in trainable:
        state = make_optimizer(make_lr_schedule(steps_per_epoch=10)).init(tr.master)
        out["mu_sharded"] = assert_llm_sharded(model.llm, mesh, tensors=state["mu"],
                                               prefix="llm.")
    loss, grads = tr._reduce_dp(*tr.gradients(batch))
    out["loss"] = {k: float(v) for k, v in loss.items()}
    out["grad_norm"] = float(tr._global_norm(grads))
    out["grads"] = {k: v.numpy() for k, v in tr.whole(grads).items()}
    return out


def _train_tool_main(state_path, stats_path, *argv):
    """``tools.train.main`` on the bridged tiny model (this file run by
    ``python -m torch.distributed.run``); rank 0 saves the returned stats."""
    import torch.distributed as dist

    from openpsg_tpu_torch.tools import train as train_tool

    stats = train_tool.main(list(argv), model=_v4(state_path, cfg_path=argv[0]))
    if dist.get_rank() == 0:
        torch.save(stats, stats_path)


if __name__ == "__main__":
    import sys

    _train_tool_main(*sys.argv[1:])
