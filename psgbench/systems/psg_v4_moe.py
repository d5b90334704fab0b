"""PSG v4 of ``openpsg_tpu_torch`` with a DeepSeek-V3-architecture LLM
(latent attention and experts) under the benchmark: ``psg_v4``'s adapter,
with the LLM built from the configuration file's top-level keys (the
model's published ``config.json``), the experts' seeded weights scaled by
each expert's fan-in, taps that also keep the program's expert choice,
and the LLM compared along that choice.

The taps hook every expert layer's router: for the sampled decode rows
they keep its top-k in every layer, in the prefill and in every trip.  The
reference (``psgbench/reference/deepseek_v3.py``) then follows that
choice, and ``route_gap`` reads how far it lies from the reference's own:
the widest amount by which a picked expert's reference score (with the
bias) lies below the reference's k-th best, over those rows' positions
that the reference computes as the program did (the prefix's real tokens
and the served tokens fed back).  The float8 control reads its own choice,
made along the same path, against the same scores."""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import torch

from psgbench.flops import moe_mla
from psgbench.reference import deepseek_v3 as ref_ds
from psgbench.reference.prec import Prec, rel_err
from psgbench.systems import psg_v4
from psgbench.systems.psg_v4 import DTYPES, MODULES, _acc, served_gaps, served_positions

# the published config.json keys the program's LLM is built from
LLM_KEYS = ("vocab_size", "hidden_size", "num_hidden_layers", "num_attention_heads",
            "num_key_value_heads", "q_lora_rank", "kv_lora_rank", "qk_nope_head_dim",
            "qk_rope_head_dim", "v_head_dim", "intermediate_size", "first_k_dense_replace",
            "moe_intermediate_size", "moe_layer_freq", "n_routed_experts", "n_shared_experts",
            "num_experts_per_tok", "routed_scaling_factor", "norm_topk_prob", "n_group",
            "topk_group", "topk_method", "scoring_func", "rope_theta", "rms_norm_eps",
            "hidden_act", "torch_dtype")


def llm_config(cfg: Dict) -> Dict:
    """The LLM's published keys, from the file's top level."""
    return {k: cfg[k] for k in LLM_KEYS if k in cfg}


def program_config(cfg: Dict):
    """The configuration file → ``PSGv4Config`` with a ``DeepseekV3Config``
    LLM (the pipeline's parts as ``psg_v4`` reads them; the stand-in Llama
    sizes it is given there only carry the width and vocabulary)."""
    from openpsg_tpu_torch.models.llm.deepseek_v3 import DeepseekV3Config

    llm = llm_config(cfg)
    stub = {"vocab_size": llm["vocab_size"], "hidden_size": llm["hidden_size"],
            "num_hidden_layers": 1, "num_attention_heads": llm["num_attention_heads"],
            "num_key_value_heads": llm["num_attention_heads"], "intermediate_size": 1,
            "rope_theta": llm["rope_theta"], "rms_norm_eps": llm["rms_norm_eps"],
            "torch_dtype": llm["torch_dtype"]}
    base = psg_v4.program_config(dict(cfg, llm=stub))
    return dataclasses.replace(base, llm=DeepseekV3Config.from_hf(
        llm, dtype=DTYPES[llm["torch_dtype"]]))


class System(psg_v4.System):
    """The model under test for one run."""

    def __init__(self, cfg: Dict, traffic: Dict, seed: int, device):
        from openpsg_tpu_torch.models.detectors.psg_v4 import PSGv4

        self.cfg, self.seed, self.device = cfg, int(seed), torch.device(device)
        self.traffic = traffic
        self.trip_budget = traffic.get("trip_budget")
        self.llm_cfg = llm_config(cfg)
        self.model = PSGv4(program_config(cfg), seed=0, device=self.device)
        m = self.model
        self.num_things = m.num_things
        self.pad_id, self.eos_id = m.tokenizer.pad_id, m.tokenizer.eos_id
        self.text_len, self.prompt_len = m.qf_parts["max_len"], m.llm_parts["max_len"]
        self.spec = psg_v4.wgen.spec_of({g: getattr(m, g) for g in MODULES})
        self.n_classes = len(m.class_names)
        self.moe_layers = [i for i, layer in enumerate(m.llm.core.layers)
                           if hasattr(layer.mlp, "gate")]
        self.set_seed(seed)
        self.taps = self.phase_taps = self._rec = self._lm_rows = None
        self._routes = None
        self._install_taps()

    def weights(self, shift: float) -> Dict[str, torch.Tensor]:
        """``psg_v4``'s draw, with each stacked expert's weights scaled by
        its own fan-in (the draw scales a 3-D tensor by its first slice's
        size, all experts' rows together)."""
        W = super().weights(shift)
        for n, v in W.items():
            if ".experts." in n and v.dim() == 3:
                v.mul_((v[0].numel() / v.shape[-1]) ** 0.5)
        return W

    def _install_taps(self):
        super()._install_taps()
        m = self.model

        def keep(i):
            def hook(mod, args, out):
                if self._routes is not None and self._lm_rows is not None:
                    self._routes[i].append(out[0][self._lm_rows])
            return hook

        for i in self.moe_layers:
            m.llm.core.layers[i].mlp.gate.register_forward_hook(keep(i))
        inner = m.tail_decode

        def tail_decode(*a, **k):
            if self.phase_taps is not None:
                self._routes = {i: [] for i in self.moe_layers}
            out = inner(*a, **k)
            if self.phase_taps is not None:
                self.phase_taps[-1]["routes"] = self._routes
                self._routes = None
            return out

        m.tail_decode = tail_decode

    def _check_llm(self, W, chunks: List[Dict], modes, out, block: int = 64):
        """As ``psg_v4``'s, along the program's expert choice, with
        ``route_gap``; the float8 control routes by its own scores (along
        the same path) and its tokens are its own argmax."""
        k = self.llm_cfg["num_experts_per_tok"]
        for T in sorted({c["trips"] for c in chunks}):
            cs = [c for c in chunks if c["trips"] == T]
            if T == 0:
                continue
            prefix = torch.cat([c["prefix"] for c in cs])
            pmask = torch.cat([c["pmask"] for c in cs])
            toks = torch.cat([c["toks"] for c in cs])[:, :T]
            logits = torch.cat([torch.stack(c["logits"][:T], 1) for c in cs])
            L = prefix.shape[1] + T - 1
            routes = {i: torch.cat([torch.cat(c["routes"][i], 1)[:, :L] for c in cs])
                      for i in self.moe_layers}
            # the positions the reference computes as the program did
            same = torch.cat([pmask.bool(), toks[:, :T - 1] != self.pad_id], 1)
            for s in range(0, prefix.shape[0], block):
                sl = slice(s, s + block)
                path = {i: r[sl] for i, r in routes.items()}
                ref, scores = ref_ds.served_logits(Prec("f32"), W, prefix[sl], pmask[sl],
                                                   toks[sl], self.llm_cfg, path)
                picked = served_positions(toks[sl], self.pad_id)
                self.detail["llm_stopped_rows"] = (self.detail.get("llm_stopped_rows", 0)
                                                   + int((~picked.all(1)).sum()))
                for mode in modes:
                    if mode == "f32":
                        got, served, chose = logits[sl], toks[sl], path
                    else:
                        got, own = ref_ds.served_logits(Prec(mode), W, prefix[sl], pmask[sl],
                                                        toks[sl], self.llm_cfg, path)
                        served = got.argmax(-1)
                        chose = {i: torch.topk(v, k, dim=-1).indices for i, v in own.items()}
                    _acc(out[mode], "llm_logits_rel", rel_err(got[picked], ref[picked]), max)
                    gaps = served_gaps(ref, served, self.pad_id, self.eos_id)
                    _acc(out[mode], "llm_gap", float(gaps.max()), max)
                    _acc(out[mode], "route_gap",
                         max(route_gap(chose[i], scores[i], same[sl], k) for i in chose), max)

    def llm_flops_per_image(self) -> float:
        rows, Lp, _ = self.decode_shape()
        trips = int(self.trip_budget or self.cfg["psg"]["max_new_tokens"])
        f = moe_mla.prefill(self.llm_cfg, rows, Lp)["flops"]
        f += sum(moe_mla.trip(self.llm_cfg, rows, Lp + t + 1)["flops"] for t in range(trips))
        return f


def route_gap(chose, scores, valid, k: int) -> float:
    """chose [B, L, k] experts, scores [B, L, E] the reference's choice
    scores, valid [B, L] → the largest amount by which a chosen expert's
    score lies below the k-th best at a valid position."""
    kth = torch.topk(scores, k, dim=-1).values[..., -1:]
    gap = torch.clamp(kth - scores.gather(-1, chose.long()), min=0).amax(-1)
    return float(gap[valid].max()) if bool(valid.any()) else 0.0
