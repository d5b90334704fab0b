"""Multi-rank dry run (counterpart of ``__graft_entry__.dryrun_multichip``):
N ranks, one process each, joined through a ``file://`` rendezvous, run
every parallel path of the port once at the tiny config and check that each
ran sharded.

    python -m openpsg_tpu_torch.tools.dryrun_multichip [--ranks 8] [--device cpu] [--root DIR]

On the card (the default) each rank takes its own GPU and the ranks talk
through NCCL, so ``--ranks`` may not exceed the GPU count; ``--device cpu``
runs them as gloo ranks on the CPU.

Phases, as in the JAX dry run:
  1. a dp×tp train step of PSG v4 (one image per dp rank, the LLM
     tp-sharded, ``assert_llm_sharded``);
  2. dp-sharded ``infer_batch`` with the tp-sharded LLM decoding;
  3. pair-sharded single-image inference (``make_pair_sharded_infer``);
  4. the scratch recipe: the tp-sharded LLM trainable, its float32 masters
     and AdamW moments held per shard;
  5. a dp×pp LLM (GPipe, remat) forward and backward;
  6. with a multiple of 8 ranks, dp×pp×tp over one mesh.
"""

from __future__ import annotations

import argparse
import tempfile

import numpy as np
import torch

DEADLINE_S = 300.0      # the whole run; a hung rank fails it


def _batch(model, rng, B):
    """A seeded global training batch of B images (the JAX dry run's)."""
    from openpsg_tpu_torch.train.trainer import build_llm_labels, sample_training_pairs

    hc = model.cfg.head
    M, R = hc.max_objects_padded, hc.num_relation_classes
    H, W = model._model_hw()
    ex = {
        "image": rng.integers(0, 255, (B, H, W, 3)).astype(np.float32),
        "object_masks": rng.uniform(size=(B, M, H // 4, W // 4)) > 0.8,
        "object_labels": rng.integers(0, 133, (B, M)).astype(np.int32),
        "object_valid": np.tile((np.arange(M) < 4)[None], (B, 1)),
        "relation_target": np.zeros((B, M, M, R), np.float32),
    }
    ex["relation_target"][:, 0, 1, 3] = 1.0
    cols = {k: [] for k in ("qf_sel_idx", "qf_sel_weight", "llm_sel_idx", "llm_valid",
                            "llm_label_ids", "llm_label_mask")}
    for b in range(B):
        v = ex["object_valid"][b]
        pv = np.repeat(v, M) & np.tile(v, M)
        qi, qw, li, lv = sample_training_pairs(rng, ex["relation_target"][b], pv,
                                               sample_size=hc.sampled_qformer_batch_size,
                                               llm_pairs=hc.max_llm_forward_num)
        ids, msk = build_llm_labels(model.tokenizer, model.relation_names,
                                    ex["relation_target"][b], li, 12)
        for k, a in zip(cols, (qi, qw, li, lv, ids, msk)):
            cols[k].append(a)
    ex.update({k: np.stack(v) for k, v in cols.items()})
    return ex


def rank_main(n: int, device: str) -> dict:
    """The dry run on one rank of ``n`` → a summary of what each phase saw."""
    import torch.distributed as dist

    from openpsg_tpu_torch.models.detectors.psg_v4 import PSGv4, PSGv4Config
    from openpsg_tpu_torch.models.llm.llama import LlamaConfig, LlamaWithEmbeddings
    from openpsg_tpu_torch.models.common import init_params
    from openpsg_tpu_torch.parallel.mesh import axis_group, make_mesh
    from openpsg_tpu_torch.parallel.pipeline import (
        make_dp_pp_mesh,
        pipelined_llama_logits,
        shard_pipeline,
    )
    from openpsg_tpu_torch.parallel.sharding import assert_llm_sharded, shard_params
    from openpsg_tpu_torch.train.trainer import (
        TrainBatch,
        V4Trainer,
        make_lr_schedule,
        make_optimizer,
    )

    rank = dist.get_rank()
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())   # the rank's card
    say = print if rank == 0 else (lambda *a, **k: None)
    out = {}
    tp = 2 if n % 2 == 0 else 1
    dp = n // tp
    mesh = make_mesh(dp=dp, tp=tp)
    say(f"mesh: {{'dp': {dp}, 'tp': {tp}}}")
    _, d, _ = axis_group(mesh, "dp")

    # 1. dp×tp train step, the LLM tensor-sharded
    model = PSGv4(PSGv4Config.tiny_test(), seed=0, device=dev)
    shard_params(model.llm, mesh)
    out["llm_sharded"] = assert_llm_sharded(model.llm, mesh) if tp > 1 else 0
    say(f"LLM tensor-sharded tensors on tp={tp}: {out['llm_sharded']}")
    ex = _batch(model, np.random.default_rng(0), dp)
    batch = TrainBatch.from_numpy({k: v[d:d + 1] for k, v in ex.items()}, dev)
    trainer = V4Trainer(model, mesh=mesh)
    opt = make_optimizer(make_lr_schedule(steps_per_epoch=10))
    metrics = trainer.train_step(batch, opt, opt.init(trainer.master))
    out["train"] = {k: float(v) for k, v in metrics.items()}
    assert all(np.isfinite(v) for v in out["train"].values()), out["train"]
    say({k: round(v, 4) for k, v in out["train"].items()})

    # 2. dp-sharded batched inference, the tp-sharded LLM decoding
    H, W = model._model_hw()
    rng = np.random.default_rng(1)
    imgs = rng.integers(0, 255, (dp, H, W, 3)).astype(np.float32)
    hws = np.tile(np.asarray([[H, W]], np.int32), (dp, 1))
    with torch.no_grad():
        results = model.infer_batch(imgs, hws, mesh=mesh)
    assert len(results) == dp and all(np.isfinite(r["pan_results"]).all() for r in results)
    out["infer_batch"] = [len(r["rel_results"]["relation"]) for r in results]
    say(f"sharded infer_batch over {dp} images OK ({out['infer_batch'][0]} triplets on img0)")

    # 3. the pair axis of one image split over dp
    res = model.make_pair_sharded_infer(mesh, axis="dp")(imgs[0], hws[0])
    assert res["rel_results"]["relation"] == results[0]["rel_results"]["relation"]
    say("pair-sharded single-image infer OK")

    # 4. the scratch recipe: a trainable tp-sharded LLM
    trainer2 = V4Trainer(model, trainable=("head", "llm"), mesh=mesh)
    opt2 = make_optimizer(make_lr_schedule(steps_per_epoch=10))
    state2 = opt2.init(trainer2.master)
    if tp > 1:
        out["moments_sharded"] = assert_llm_sharded(model.llm, mesh, tensors=state2["mu"],
                                                    prefix="llm.")
    metrics2 = trainer2.train_step(batch, opt2, state2)
    assert all(np.isfinite(float(v)) for v in metrics2.values())
    if tp > 1:
        assert_llm_sharded(model.llm, mesh, tensors=trainer2.master, prefix="llm.")
        say(f"scratch recipe: trainable LLM sharded, {out['moments_sharded']} sharded "
            "moment tensors, step OK")

    # 5./6. the LLM trunk as a GPipe pipeline (dp×pp), then dp×pp×tp
    meshes = []
    pp = 4 if n % 4 == 0 else (2 if n % 2 == 0 else 1)
    if pp > 1:
        meshes.append(("pp", dict(pp=pp, dp=n // pp, tp=1), 2 * pp, 3))
    if n % 8 == 0:
        meshes.append(("3d", dict(pp=2, dp=n // 4, tp=2), 4, 6))
    for tag, shape, layers, seed in meshes:
        cfg = LlamaConfig(vocab_size=64, dim=32, n_layers=layers, n_heads=4, n_kv_heads=2,
                          ffn_hidden=64, max_seq_len=32, dtype=torch.float32)
        with torch.device("meta"):
            llm = LlamaWithEmbeddings(cfg)
        llm = llm.to_empty(device="cpu")
        init_params(llm, torch.Generator().manual_seed(seed))
        llm = llm.to(dev)
        pmesh = make_dp_pp_mesh(**shape)
        shard_pipeline(llm, pmesh)
        g = torch.Generator().manual_seed(seed + 1)
        B, L = 2 * shape["dp"], 12
        emb = torch.randn(B, L, cfg.dim, generator=g).to(dev)
        tgt = torch.randint(0, cfg.vocab_size, (B, L), generator=g).to(dev)
        _, dd, ndp = axis_group(pmesh, "dp")
        rows = slice(dd * B // ndp, (dd + 1) * B // ndp)
        logits = pipelined_llama_logits(
            llm, emb[rows], torch.ones(B // ndp, L, dtype=torch.bool, device=dev),
            torch.arange(L, device=dev).repeat(B // ndp, 1), pmesh, n_micro=2, remat=True)
        loss = -torch.log_softmax(logits, -1).gather(-1, tgt[rows, :, None]).mean()
        loss.backward()
        n_grads = sum(p.grad is not None for n_, p in llm.named_parameters()
                      if n_.startswith("core.layers."))
        assert np.isfinite(float(loss.detach())) and n_grads > 0
        lo, hi = llm.core.stage_range
        out[tag] = dict(loss=float(loss.detach()), stage_layers=(lo, hi), layer_grads=n_grads)
        say(f"{'pipeline-parallel' if tag == 'pp' else '3D-parallel'} LLM "
            f"({', '.join(f'{k}={v}' for k, v in shape.items())}, GPipe fwd+bwd, remat) OK "
            f"— loss {float(loss.detach()):.4f}, stage layers [{lo}, {hi}), {n_grads} layer grads")
    say(f"dryrun_multichip({n}) OK")
    return out


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(prog="python -m openpsg_tpu_torch.tools.dryrun_multichip")
    ap.add_argument("--ranks", type=int, default=8)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda (default): one rank per GPU over NCCL; cpu: gloo ranks")
    ap.add_argument("--root", default=None, help="rendezvous and log directory")
    args = ap.parse_args(argv)
    from openpsg_tpu_torch.parallel.launch import spawn

    if args.device == "cuda":
        cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if args.ranks > cards:
            raise SystemExit(f"--ranks {args.ranks} on the card needs {args.ranks} GPUs and "
                             f"{cards} are visible (NCCL takes one rank per GPU); pass "
                             "--device cpu for gloo ranks on the CPU")
    with tempfile.TemporaryDirectory() as tmp:
        root = args.root or tmp
        results = spawn("openpsg_tpu_torch.tools.dryrun_multichip:rank_main", args.ranks,
                        root, args=(args.ranks, args.device), device=args.device,
                        timeout_s=DEADLINE_S)
        with open(f"{root}/rank0.log") as f:
            print(f.read(), end="")
    return results


if __name__ == "__main__":
    main()
