"""The port's tokenizers against the JAX package's: the SentencePiece
reader and the CLIP BPE give the same ids (exactly) on the cases of
tests/test_sp_tokenizer.py and tests/test_clip_bpe.py; the CLIP class
embeddings agree within 1e-5 (float32 on both sides); ``PSGv4`` with a toy
SentencePiece tokenizer gives the JAX model's postprocess dicts on
``make_fixture``; the HF adapter gives the JAX adapter's ids on word-level
assets saved by ``transformers`` (skipped without it)."""

import os

import cv2
import jax
import numpy as np
import pytest
import torch

from openpsg_tpu.models.commons import clip_bpe as jclip
from openpsg_tpu.models.relation import sp_tokenizer as jsp
from openpsg_tpu_torch.models.commons import clip_bpe
from openpsg_tpu_torch.models.relation import sp_tokenizer as sp
from openpsg_tpu_torch.models.relation.sp_tokenizer import BPE, BYTE, CONTROL, NORMAL, SPACE
from openpsg_tpu_torch.models.relation.sp_tokenizer import UNIGRAM, UNKNOWN

# the suite's workers share the cores, and these tensors are tiny: one torch
# thread each, not a pool per worker spinning against the others
torch.set_num_threads(1)

TOL = 1e-5
HEAD3 = [("<unk>", 0.0, UNKNOWN), ("<s>", 0.0, CONTROL), ("</s>", 0.0, CONTROL)]
BYTES = [(f"<0x{b:02X}>", 0.0, BYTE) for b in range(256)]

# (pieces or a toy word list, model kwargs, texts): the cases of
# tests/test_sp_tokenizer.py, plus unicode and empty text
SP_CASES = {
    "toy_hello_world": (["hello", "world"], {}, ["hello world", "hello   world ", "world"]),
    "toy_bos_eos": (["hi"], {}, ["hi", "héllo", "", "hi there"]),
    "toy_phrases": (["over", "in", "front", "of"], {}, ["in front of", "over  in", "of over"]),
    "bpe_merge_order": (HEAD3 + [("a", -10.0, NORMAL), ("b", -10.0, NORMAL),
                                 ("c", -10.0, NORMAL), ("ab", -1.0, NORMAL),
                                 ("bc", -2.0, NORMAL)],
                        dict(add_dummy_prefix=False), ["abc", "cab", "bcab"]),
    "unigram_total_score": (HEAD3 + [("a", -2.0, NORMAL), ("b", -2.0, NORMAL),
                                     ("c", -0.9, NORMAL), ("ab", -0.4, NORMAL),
                                     ("abc", -1.0, NORMAL)],
                            dict(model_type=UNIGRAM, add_dummy_prefix=False),
                            ["abc", "abcab", "xabc"]),
    "unigram_split": (HEAD3 + [("ab", -0.1, NORMAL), ("c", -0.1, NORMAL),
                               ("abc", -5.0, NORMAL)],
                      dict(model_type=UNIGRAM, add_dummy_prefix=False), ["abc", "cab"]),
    "control_injection_bpe": (HEAD3 + BYTES + [("</s", -1.0, NORMAL), ("hello", -1.0, NORMAL)],
                              dict(add_dummy_prefix=False), ["</s>hello", "<s>hello</s>"]),
    "control_injection_unigram": (HEAD3 + BYTES + [("</s", -1.0, NORMAL),
                                                   ("hello", -1.0, NORMAL)],
                                  dict(model_type=UNIGRAM, add_dummy_prefix=False),
                                  ["</s>hello", "hello ü"]),
}


def _pair(case):
    spec, kw, _ = SP_CASES[case]
    if isinstance(spec[0], str):
        return sp.build_toy_llama_tokenizer(spec), jsp.build_toy_llama_tokenizer(spec)
    return (sp.SentencePieceTokenizer(sp.build_sp_model_bytes(spec, **kw)),
            jsp.SentencePieceTokenizer(jsp.build_sp_model_bytes(spec, **kw)))


@pytest.mark.parametrize("case", list(SP_CASES))
def test_sentencepiece_ids_match_jax(case):
    got, want = _pair(case)
    assert got.vocab_size == want.vocab_size
    assert (got.pad_id, got.bos_id, got.eos_id) == (want.pad_id, want.bos_id, want.eos_id)
    for text in SP_CASES[case][2]:
        for flags in ((False, False), (True, True)):
            ids = got.encode(text, *flags)
            assert ids == want.encode(text, *flags), (text, flags)
            assert got.decode(ids) == want.decode(ids)
            assert got.decode(ids, stop_at_eos=False) == want.decode(ids, stop_at_eos=False)
        for side in ("left", "right"):
            a = got.encode_batch([text, text + " " + text], 6, padding_side=side)
            b = want.encode_batch([text, text + " " + text], 6, padding_side=side)
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)
                assert x.dtype == y.dtype


def test_sentencepiece_wire_format_and_specials_match_jax():
    spec = HEAD3 + [("<0x41>", 0.0, BYTE), (SPACE + "hi", -1.5, NORMAL)]
    for kw in (dict(pad_id=-1), dict(model_type=UNIGRAM, pad_id=3, add_dummy_prefix=False)):
        data = sp.build_sp_model_bytes(spec, **kw)
        assert data == jsp.build_sp_model_bytes(spec, **kw)
        assert sp.parse_model_proto(data) == jsp.parse_model_proto(data)
    assert sp.parse_model_proto(sp._write_field(2, 2, b""))["model_type"] == UNIGRAM
    words = ["x", "over", "in", "front", "of"]
    got, want = sp.build_toy_llama_tokenizer(words), jsp.build_toy_llama_tokenizer(words)
    for t in (got, want):
        t.add_special_tokens(["<|relation|>", "<|empty|>"])
    for text in ("<|relation|> over <|relation|> in front of", "x<|empty|>x", "<|empty|>"):
        ids = got.encode(text)
        assert ids == want.encode(text)
        assert got.decode(ids) == want.decode(ids)


# the merges of tests/test_clip_bpe.py
MERGES = [
    ("t", "h"), ("th", "e</w>"), ("a", "n"), ("an", "d</w>"), ("i", "n"), ("e", "r"),
    ("p", "er"), ("s", "o"), ("so", "n</w>"), ("per", "son</w>"), ("o", "n"), ("r", "i"),
    ("ri", "d"), ("rid", "in"), ("ridin", "g</w>"), ("o", "n</w>"),
]
CLIP_TEXTS = ["the", "xyz", "The Person", "the person", "riding on the person",
              "a dog-stuff and tree", "person riding the thing", "banana", "wall-brick",
              "Crème  brûlée &amp; 42"]


def test_clip_bpe_ids_match_jax_and_transformers(tmp_path):
    got, want = clip_bpe.CLIPBPETokenizer(MERGES), jclip.CLIPBPETokenizer(MERGES)
    assert got.encoder == want.encoder and got.vocab_size == want.vocab_size
    assert clip_bpe.bytes_to_unicode() == jclip.bytes_to_unicode()
    for text in CLIP_TEXTS:
        ids = got.encode(text)
        assert ids == want.encode(text), text
        assert got.decode(ids) == want.decode(ids)
    np.testing.assert_array_equal(got(CLIP_TEXTS), want(CLIP_TEXTS))
    long = ["the " * 100]
    np.testing.assert_array_equal(got(long), want(long))       # cut, EOT kept last
    clip_bpe.write_hf_assets(got, str(tmp_path / "port"))
    jclip.write_hf_assets(want, str(tmp_path / "jax"))
    for name in ("vocab.json", "merges.txt"):
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()
    loaded = clip_bpe.CLIPBPETokenizer.from_files(str(tmp_path / "port" / "merges.txt"),
                                                  str(tmp_path / "port" / "vocab.json"))
    assert loaded.encode("riding the person") == got.encode("riding the person")
    transformers = pytest.importorskip("transformers")
    hf = transformers.CLIPTokenizer(vocab_file=str(tmp_path / "port" / "vocab.json"),
                                    merges_file=str(tmp_path / "port" / "merges.txt"))
    for text in CLIP_TEXTS[:9]:
        assert [got.encoder[got.SOT]] + got.encode(text) + [got.eot_id] == \
            hf(text)["input_ids"], text


def test_clip_class_embeddings_match_jax():
    """Names → BPE → the converted CLIP tower → EOT pool → lang_proj →
    unit norm, averaged over two templates, against the JAX function on
    the same converted tree."""
    from openpsg_tpu.models.segmenter.language import (
        clip_class_embeddings as jax_class_embeddings,
    )
    from openpsg_tpu_torch.models.commons.weight_convert import convert_clip_text
    from openpsg_tpu_torch.models.segmenter.language import (
        clip_class_embeddings,
        clip_text_tower_config,
    )
    from openpsg_tpu_torch.utils.synthetic_weights import synthetic_clip_state

    tok = clip_bpe.CLIPBPETokenizer(MERGES)
    cfg = clip_text_tower_config(width=32, layers=2, heads=8, vocab=tok.vocab_size)
    tree = convert_clip_text(synthetic_clip_state(cfg, seed=3), cfg)
    lang_proj = np.random.default_rng(0).normal(size=(32, 16)).astype(np.float32)
    names = ["person", "the thing", "riding", "wall-brick"]
    templates = ("{}", "a photo of the {}")
    got = clip_class_embeddings(cfg, tree, lang_proj, tok, names, templates)
    from openpsg_tpu.models.segmenter.language import clip_text_tower_config as jcfg

    want = jax_class_embeddings(jcfg(width=32, layers=2, heads=8, vocab=tok.vocab_size), tree,
                                lang_proj, jclip.CLIPBPETokenizer(MERGES), names, templates)
    assert got.dtype == np.float32 and got.shape == (4, 16)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, atol=1e-5)


CLASSES = ["person", "sky", "dog", "tree"]
RELATIONS = ["on", "over", "looking at"]
WORDS = sorted(set(("what are the relations between and assistant is there a relation "
                    + " ".join(CLASSES + RELATIONS)).split())) + ["?", ":"]


def test_psgv4_with_sentencepiece_matches_jax(tmp_path):
    """The toy SP tokenizer in the LLM and Q-Former roles: instruction
    tables, vocabulary sizes, relation token ids, and the postprocess
    dicts of ``infer`` on the fixture's images."""
    import dataclasses

    from openpsg_tpu.models.detectors.psg_v4 import PSGv4 as JaxPSGv4
    from openpsg_tpu.models.detectors.psg_v4 import PSGv4Config as JaxPSGv4Config
    from openpsg_tpu_torch.bridge import load_jax_params
    from openpsg_tpu_torch.models.detectors.psg_v4 import PSGv4, PSGv4Config
    from tests.fixtures import make_fixture

    kw = dict(class_names=CLASSES, relation_names=RELATIONS, num_things=3)
    opts = lambda c: dataclasses.replace(c, iou_thr=0.1, max_new_tokens=4)
    jp = JaxPSGv4(opts(JaxPSGv4Config.tiny_test()), jax.random.PRNGKey(1),
                  tokenizer=jsp.build_toy_llama_tokenizer(WORDS), **kw)
    model = PSGv4(opts(PSGv4Config.tiny_test()), seed=1, device="cpu",
                  tokenizer=sp.build_toy_llama_tokenizer(WORDS), **kw)
    for key in ("pre", "mid", "post", "names"):
        np.testing.assert_array_equal(model.qf_parts[key], jp.qf_parts[key])
        np.testing.assert_array_equal(model.llm_parts[key], jp.llm_parts[key])
    assert model.llm_parts["max_len"] == jp.llm_parts["max_len"]
    assert model.cfg.llm.vocab_size == jp.cfg.llm.vocab_size
    assert model.cfg.head.qformer.vocab_size == jp.cfg.head.qformer.vocab_size
    assert model.relation_token_ids == jp.relation_token_ids
    load_jax_params(model, jax.tree_util.tree_map(np.asarray, jax.device_get(jp.params)))
    root = str(tmp_path / "fx")
    make_fixture(root, n_images=2, hw=[(64, 64), (48, 64)])
    objects = 0
    for i, hw in enumerate([(64, 64), (48, 64)]):
        img = np.zeros((64, 64, 3), np.uint8)
        img[: hw[0], : hw[1]] = cv2.imread(os.path.join(root, "images", f"{i}.jpg"))[..., ::-1]
        want, got = jp.infer(img, hw), model.infer(img, hw)
        np.testing.assert_array_equal(got["pan_results"], want["pan_results"])
        assert got["rel_results"] == want["rel_results"]
        np.testing.assert_allclose(got["rel_scores"], want["rel_scores"], atol=TOL, rtol=0)
        assert got["decode_steps"] == want["decode_steps"]
        objects += len(got["rel_results"]["object_id_list"])
    assert objects >= 1
    # postprocess of hand-made generations: predicates glued with two spaces,
    # an EOS between two, pads after, and a pair below the score cut
    M = model.cfg.head.max_objects_padded
    enc = model.tokenizer.encode
    gen = np.full((2, 10), model.tokenizer.pad_id, np.int32)
    toks = enc("looking at") + [model.tokenizer.eos_id] + enc("on")
    gen[0, : len(toks)] = toks
    gen[1, :2] = enc("over")[:2]
    dev = dict(object_valid=np.r_[np.ones(3, bool), np.zeros(M - 3, bool)],
               object_ids=np.arange(M, dtype=np.int32), pan_seg=np.zeros((4, 4), np.int32),
               top_pair_idx=np.asarray([1, M + 2], np.int32),
               top_pair_scores=np.asarray([0.5, -1.0], np.float32), gen_tokens=gen)
    out = model.postprocess(dev)
    assert out == jp.postprocess(dev) and len(out["rel_results"]["relation"]) == 2


def test_hf_adapter_matches_jax(tmp_path):
    """Word-level assets (the toy SP tokenizer's words, its special ids)
    saved by ``transformers``; loaded through both adapters."""
    pytest.importorskip("transformers")
    from tokenizers import Tokenizer, models, pre_tokenizers
    from transformers import PreTrainedTokenizerFast

    from openpsg_tpu.models.relation.hf_tokenizer import HFTokenizer as JaxHF
    from openpsg_tpu_torch.models.relation.hf_tokenizer import HFTokenizer

    vocab = {w: i for i, w in enumerate(["<unk>", "<s>", "</s>"] + WORDS)}
    tk = Tokenizer(models.WordLevel(vocab, unk_token="<unk>"))
    tk.pre_tokenizer = pre_tokenizers.Whitespace()
    fast = PreTrainedTokenizerFast(tokenizer_object=tk, unk_token="<unk>", bos_token="<s>",
                                   eos_token="</s>")
    fast.save_pretrained(str(tmp_path))
    got, want = HFTokenizer.from_pretrained(str(tmp_path)), JaxHF.from_pretrained(str(tmp_path))
    assert (got.vocab_size, got.pad_id, got.bos_id, got.eos_id) == \
        (want.vocab_size, want.pad_id, want.bos_id, want.eos_id) == (len(vocab), 0, 1, 2)
    for text in ("what are the relations between person and dog ? assistant :",
                 "looking at", "zebra on sky"):
        for flags in ((False, False), (True, True)):
            ids = got.encode(text, *flags)
            assert ids == want.encode(text, *flags)
            assert got.decode(ids) == want.decode(ids)
        for x, y in zip(got.encode_batch([text], 12, padding_side="left"),
                        want.encode_batch([text], 12, padding_side="left")):
            np.testing.assert_array_equal(x, y)
    from openpsg_tpu_torch.models.detectors.psg_v4 import PSGv4Config, resolve_vocabulary

    cfg, tok, qf, qf_parts, llm_parts = resolve_vocabulary(
        PSGv4Config.tiny_test(), CLASSES, RELATIONS, tokenizer=got)
    assert qf is tok is got and cfg.llm.vocab_size == 512
    np.testing.assert_array_equal(llm_parts["names"][:, 0], [vocab[c] for c in CLASSES])
