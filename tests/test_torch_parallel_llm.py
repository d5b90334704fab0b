"""The port's tensor- and pipeline-parallel LLM against the JAX package.

* Spec level: ``plan_shardings`` on ``meta`` Llama-2-7B modules (bf16 and
  int8) equals the JAX ``plan_shardings`` on ``ShapeDtypeStruct`` trees
  for tp 2, 4 and 8, after the layout transposition (port ``[out, in]``,
  flax ``[in, out]``); at tiny shapes the plans differ exactly where the
  port keeps whole kv heads.
* tp 2 and 4 (gloo ranks on the CPU, bridged JAX weights): float32 logits
  within 1e-5 of the JAX tp-sharded and unsharded forward, and every
  parameter's gradient within 1e-5 (relative) of the unsharded port's
  (which ``test_torch_train.py`` holds to ``jax.grad``); the int8 LLM,
  weight-only and with int8 activations at ≥ 256 rows: greedy tokens
  identical to the JAX decode.
* GPipe: pp 2 and 4, n_micro 1, 2 and 4, ``last_logit_only``, int8,
  dp×pp and dp×pp×tp: logits within 1e-5 of the unsharded JAX forward,
  gradients (embeddings and every parameter) within 1e-4 of ``jax.grad``.

Each spawn is one group of gloo ranks (``parallel.launch.spawn``, a
``file://`` rendezvous under ``tmp_path``) running several cases: one of 4
ranks for the tp cases and the 4-rank pipeline cases, then one of 8, in a
thread that starts before the JAX references are computed.
"""

import dataclasses
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from openpsg_tpu.models.llm.decode import greedy_decode as jax_greedy
from openpsg_tpu.models.llm.llama import LlamaConfig as JaxCfg
from openpsg_tpu.models.llm.llama import LlamaWithEmbeddings as JaxLlama
from openpsg_tpu.models.llm.llama import quantize_llama as jax_quantize
from openpsg_tpu.parallel.mesh import make_mesh as jax_make_mesh
from openpsg_tpu.parallel.sharding import plan_shardings as jax_plan
from openpsg_tpu.parallel.sharding import shard_params as jax_shard
from openpsg_tpu_torch.bridge import jax_paths, part_state_dict
from openpsg_tpu_torch.models.llm.llama import LlamaConfig, LlamaWithEmbeddings
from openpsg_tpu_torch.parallel.launch import spawn
from openpsg_tpu_torch.parallel.sharding import plan_shardings

# the suite's workers share the cores, and these tensors are tiny: one torch
# thread each, not a pool per worker spinning against the others
torch.set_num_threads(1)

STEPS = 4


# ------------------------------------------------------------- spec level
def _norm(spec):
    s = tuple(spec)
    while s and s[-1] is None:
        s = s[:-1]
    return s


def _port_specs_in_jax_layout(module, tp):
    """{JAX leaf path: the port's spec transposed to the flax layout}."""
    plan = plan_shardings(module, {"tp": tp})
    paths = jax_paths(module, "llm")
    out = {}
    for name, spec in plan.items():
        path = paths[name]
        spec = tuple(spec) + (None,) * (2 - len(spec)) if spec else ()
        if spec and path.rsplit("/", 1)[1] in ("kernel", "kernel_q"):
            spec = spec[::-1]
        if "/layers/" in path:
            spec = (None,) + spec if spec else ()
        prev = out.setdefault(path, _norm(spec))
        assert prev == _norm(spec), path          # every layer plans alike
    return out


def _jax_specs(cfg, tp):
    model = JaxLlama(cfg)
    shapes = jax.eval_shape(lambda k: model.init(
        k, token_ids=jnp.zeros((1, 8), jnp.int32), attention_mask=jnp.ones((1, 8), bool),
        positions=jnp.zeros((1, 8), jnp.int32)), jax.random.PRNGKey(0))
    specs = jax_plan(shapes, jax_make_mesh(dp=8 // tp, tp=tp))
    flat = jax.tree_util.tree_flatten_with_path(specs, is_leaf=lambda x: isinstance(x, P))[0]
    return {"llm/" + "/".join(str(getattr(k, "key", k)) for k in path): _norm(s)
            for path, s in flat}


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
def test_plan_matches_jax_at_llama2_7b(quant):
    for tp in (2, 4, 8):
        with torch.device("meta"):
            port = LlamaWithEmbeddings(LlamaConfig(quant=quant))
        got = _port_specs_in_jax_layout(port, tp)
        want = _jax_specs(JaxCfg(quant=quant), tp)
        assert got == want, tp
        n_tp = sum("tp" in s for s in want.values())
        assert n_tp == (15 if quant else 9), (tp, n_tp)


def test_plan_keeps_whole_kv_heads_at_tiny_shapes():
    """tiny: 4 heads, 2 kv heads.  tp 2: the plans agree; tp 4: GSPMD
    splits k/v mid-head, the port replicates them (and their int8 scales)."""
    for quant in (False, True):
        cfg = dataclasses.replace(LlamaConfig.tiny_test(vocab_size=32), quant=quant)
        with torch.device("meta"):
            port = LlamaWithEmbeddings(cfg)
        jcfg = dataclasses.replace(JaxCfg.tiny_test(vocab_size=32), quant=quant)
        assert _port_specs_in_jax_layout(port, 2) == _jax_specs(jcfg, 2)
        got, want = _port_specs_in_jax_layout(port, 4), _jax_specs(jcfg, 4)
        differ = {p for p in want if got[p] != want[p]}
        leaves = ("kernel_q", "scale") if quant else ("kernel",)
        assert differ == {f"llm/params/core/layers/{m}/{leaf}" for m in ("wk", "wv")
                          for leaf in leaves}
        assert all(got[p] == () for p in differ)


# ------------------------------------------------------------ the ranks
def _cfg_kw(cfg):
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


def _jax_llm(cfg, seed):
    model = JaxLlama(cfg)
    params = jax.jit(lambda k: model.init(
        k, token_ids=jnp.zeros((1, 4), jnp.int32), attention_mask=jnp.ones((1, 4), bool),
        positions=jnp.zeros((1, 4), jnp.int32)))(jax.random.PRNGKey(seed))
    return model, params


def _save_port(params, path):
    state = {k: torch.from_numpy(v) for k, v in part_state_dict(
        "llm", jax.tree_util.tree_map(np.asarray, jax.device_get(params))).items()}
    torch.save(state, path)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The tp and pipeline cases' inputs and bridged weights, and their rank
    groups, started in a thread before the JAX references are computed: one
    spawn of 4 ranks (the tp cases, then the 4-rank pipeline cases), then
    one of 8.  ``result()`` waits → {world: per rank, the cases' results}."""
    root = tmp_path_factory.mktemp("ranks")
    out = {"tp": _tp_inputs(root), "pp": _pp_inputs(root)}
    tasks = {4: out["tp"]["tasks"] + out["pp"]["tasks"][4], 8: out["pp"]["tasks"][8]}
    def run():
        return {world: spawn("torch_parallel_ranks:llm_suite", world, str(root / f"w{world}"),
                             args=(group,), timeout_s=180) for world, group in tasks.items()}

    out["result"] = ThreadPoolExecutor(1).submit(run).result
    return out


def _tp_inputs(root):
    """The tiny LLM (float32, int8 weight-only, int8 activations) bridged
    for tp 2 and tp 4 rank groups."""
    rng = np.random.default_rng(3)
    B, L = 3, 90                              # 270 prefill rows: act_int8 engages
    emb = rng.normal(size=(B, L, 64)).astype(np.float32)
    mask = np.ones((B, L), bool)
    mask[1, :4] = False
    mask[2, 40:43] = False                    # mid-sequence pads (HF positions)
    pos = np.maximum(np.cumsum(mask, 1) - 1, 0).astype(np.int32)
    inputs = dict(embeds=emb, mask=mask, positions=pos.astype(np.int64),
                  ids=rng.integers(0, 32, (B, 7)))
    cfg = JaxCfg.tiny_test(vocab_size=32)
    model, params = _jax_llm(cfg, 7)
    tasks, quantized = [], {}
    for mode in ("f32", "int8", "act_int8"):
        mp = params if mode == "f32" else jax_quantize(params)
        quantized[mode] = mp
        path = str(root / f"{mode}.pt")
        _save_port(mp, path)
        port_cfg = dataclasses.replace(LlamaConfig.tiny_test(vocab_size=32),
                                       quant=mode != "f32", act_int8=mode == "act_int8")
        for tp in (2, 4):
            tasks.append(("llm_tp", (_cfg_kw(port_cfg), path, inputs, tp, STEPS, 31)))
    return dict(inputs=inputs, cfg=cfg, model=model, params=quantized, tasks=tasks)


@pytest.fixture(scope="module")
def tp_case(ranks):
    """The JAX references of the tp cases, and the ranks' results."""
    tp = ranks["tp"]
    emb, mask, pos = (tp["inputs"][k] for k in ("embeds", "mask", "positions"))
    model, cfg, params = tp["model"], tp["cfg"], tp["params"]["f32"]
    apply = jax.jit(lambda p: model.apply(p, input_embeds=emb, attention_mask=mask,
                                          positions=pos)[0])
    want = {"logits": np.asarray(apply(params)),
            "embed": np.asarray(model.apply(params, jnp.asarray(tp["inputs"]["ids"]),
                                            method=lambda m, i: m.embed(i)))}
    for n in (2, 4):
        with jax_make_mesh(dp=8 // n, tp=n):
            want[f"logits_tp{n}"] = np.asarray(apply(jax_shard(params, jax_make_mesh(
                dp=8 // n, tp=n))))
    for mode in ("int8", "act_int8"):
        qm = JaxLlama(dataclasses.replace(cfg, quant=True, act_int8=mode == "act_int8"))
        toks, _, trips = jax.jit(lambda p, qm=qm: jax_greedy(
            qm, p, jnp.asarray(emb), jnp.asarray(mask), STEPS, eos_id=31,
            return_trips=True))(tp["params"][mode])
        want[f"tokens_{mode}"] = np.asarray(toks)
    n = len(tp["tasks"])
    got = [rank[:n] for rank in ranks["result"]()[4]]
    return want, tp["tasks"], got


def test_tp_forward_matches_jax(tp_case):
    want, tasks, got = tp_case
    for i, (_, args) in enumerate(tasks):
        if args[0]["quant"]:
            continue
        tp = args[3]
        for rank in got:
            res = rank[i]
            np.testing.assert_allclose(res["logits"], want["logits"], atol=1e-5, rtol=0)
            np.testing.assert_allclose(res["logits"], want[f"logits_tp{tp}"], atol=1e-5, rtol=0)
            np.testing.assert_array_equal(res["embed"], want["embed"])
            assert res["n_sharded"] == (16 if tp == 2 else 12)
            # every parameter trained through the tp LLM (tp 4 keeps k/v
            # replicated and cuts them to each rank's kv heads): gradients
            # within 1e-5 of the unsharded LLM's, relative to each leaf
            assert res["grad_err"] <= 1e-5, (tp, res["grad_err"])


@pytest.mark.parametrize("mode", ["int8", "act_int8"])
def test_tp_int8_greedy_tokens_match_jax(tp_case, mode):
    want, tasks, got = tp_case
    cases = [i for i, (_, a) in enumerate(tasks)
             if a[0]["quant"] and a[0]["act_int8"] == (mode == "act_int8")]
    assert len(cases) == 2
    for i in cases:
        for rank in got:
            np.testing.assert_array_equal(rank[i]["tokens"], want[f"tokens_{mode}"])


# --------------------------------------------------------------- pipeline
PP_CFG = dict(vocab_size=64, dim=32, n_layers=4, n_heads=4, n_kv_heads=2, ffn_hidden=64,
              max_seq_len=32)


# (pp, dp, tp, n_micro, last_logit_only, remat, grads, int8) on 4 and on 8 ranks
PP_CASES = {4: [(4, 1, 1, 4, False, True, True, False), (4, 1, 1, 1, False, False, False, False),
                (4, 1, 1, 2, True, False, False, False), (2, 2, 1, 1, False, False, False, False),
                (2, 2, 1, 2, False, True, True, False), (2, 1, 2, 2, False, False, True, False),
                (2, 2, 1, 2, False, False, False, True)],
            8: [(2, 2, 2, 2, False, True, True, False), (2, 2, 2, 2, False, False, False, True)]}


def _pp_inputs(root):
    """The pipeline cases' inputs, their float32 and int8 weights bridged,
    and the tasks of each world."""
    rng = np.random.default_rng(5)
    B, L = 8, 10
    emb = rng.normal(size=(B, L, 32)).astype(np.float32)
    mask = np.ones((B, L), bool)
    mask[2, 3:5] = False
    pos = np.maximum(np.cumsum(mask, 1) - 1, 0).astype(np.int32)
    tgt = rng.integers(0, 64, (B, L))
    inputs = dict(embeds=emb, mask=mask, positions=pos.astype(np.int64), targets=tgt)
    ref = {}
    for quant in (False, True):
        cfg = JaxCfg(**PP_CFG, dtype=jnp.float32, quant=quant)
        model, params = _jax_llm(dataclasses.replace(cfg, quant=False), 1)
        if quant:
            params, model = jax_quantize(params), JaxLlama(cfg)
        path = str(root / f"q{int(quant)}.pt")
        _save_port(params, path)
        ref[quant] = dict(path=path, model=model, params=params,
                          cfg=_cfg_kw(LlamaConfig(**PP_CFG, dtype=torch.float32, quant=quant)))
    tasks = {world: [("llm_pipeline", (ref[q]["cfg"], ref[q]["path"], inputs, pp, dp, tp, nm,
                                       last, remat, grads))
                     for pp, dp, tp, nm, last, remat, grads, q in cases]
             for world, cases in PP_CASES.items()}
    return dict(inputs=inputs, ref=ref, tasks=tasks)


@pytest.fixture(scope="module")
def pp_case(ranks):
    """The pipeline cases on 4 ranks (pp 4; pp 2 × dp 2; pp 2 × tp 2) and on
    8 (dp 2 × pp 2 × tp 2), against the unsharded JAX forward and grads."""
    pp = ranks["pp"]
    emb, mask, pos, tgt = (pp["inputs"][k] for k in ("embeds", "mask", "positions", "targets"))
    pos = pos.astype(np.int32)
    ref = {}
    for quant, r in pp["ref"].items():
        model, params = r["model"], r["params"]

        def loss(p, e, model=model):
            lg = model.apply(p, input_embeds=e, attention_mask=mask, positions=pos)[0]
            lp = jnp.take_along_axis(jax.nn.log_softmax(lg), jnp.asarray(tgt)[..., None], -1)
            return -jnp.sum(lp) / tgt.size, lg

        ref[quant] = {}
        if quant:       # int8 weights take no gradient: logits only
            ref[quant]["logits"] = np.asarray(jax.jit(loss)(params, jnp.asarray(emb))[1])
        else:
            (_, lg), (g, ge) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))(
                params, jnp.asarray(emb))
            ref[quant].update(logits=np.asarray(lg), emb_grad=np.asarray(ge), grads=part_state_dict(
                "llm", jax.tree_util.tree_map(np.asarray, g)))
    got = ranks["result"]()
    n_tp = len(ranks["tp"]["tasks"])
    out = []
    for world, cases in PP_CASES.items():
        first = n_tp if world == 4 else 0
        out += [(c, [rank[first + i] for rank in got[world]]) for i, c in enumerate(cases)]
    return ref, out


def test_pipeline_forward_matches_unsharded(pp_case):
    ref, out = pp_case
    for case, ranks in out:
        last, quant = case[4], case[7]
        want = ref[quant]["logits"]
        for res in ranks:
            w = want[slice(*res["rows"])]
            if last:
                w = w[:, -1:]
            assert res["logits"].shape == w.shape, case
            if quant:
                # int8 weights, float32 activations: the same work in
                # another order (tp sums) — tight, not bitwise
                np.testing.assert_allclose(res["logits"], w, atol=1e-4, rtol=0, err_msg=str(case))
            else:
                np.testing.assert_allclose(res["logits"], w, atol=1e-5, rtol=0, err_msg=str(case))


def test_pipeline_grads_match_unsharded(pp_case):
    ref, out = pp_case
    checked = 0
    for case, ranks in out:
        if not case[6]:
            continue
        want = ref[False]
        for res in ranks:
            np.testing.assert_allclose(res["emb_grad"], want["emb_grad"][slice(*res["rows"])],
                                       atol=1e-4, rtol=0, err_msg=str(case))
            assert set(res["grads"]) == set(want["grads"])
            for name, g in res["grads"].items():
                np.testing.assert_allclose(g, want["grads"][name], atol=1e-4, rtol=0,
                                           err_msg=f"{case} {name}")
            checked += 1
    assert checked == 4 + 4 + 4 + 8
