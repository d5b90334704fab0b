"""CLIP byte-pair-encoding tokenizer (OpenAI SimpleTokenizer semantics;
counterpart of ``openpsg_tpu/models/commons/clip_bpe.py``, a copy).

The OpenSeeD language encoder tokenizes class names with CLIP's BPE
before computing the text embeddings the segmenter classifies against
(reference: openseed_relation_v2.py:59-60 calls
``lang_encoder.get_text_embeddings(thing+stuff)``; OpenSeeD inherits
X-Decoder's CLIP tokenizer).  This is a self-contained reimplementation:

  * byte→unicode table, word-final ``</w>`` marker, rank-greedy merges —
    exactly OpenAI's ``clip/simple_tokenizer.py`` algorithm;
  * loads the standard asset formats: a ``merges.txt`` (one merge per
    line, optional version header) plus optional ``vocab.json``; or the
    single ``bpe_simple_vocab_16e6.txt(.gz)`` file OpenAI ships (in which
    case the vocab is derived from the merges, as OpenAI does);
  * text cleanup: whitespace collapse + lowercase.  ``ftfy`` mojibake
    fixing is applied when the package exists; PSG class names are plain
    ASCII so its absence does not change tokenization here.

Ids equal the JAX package's and ``transformers.CLIPTokenizer``'s on the
same asset files (tests/test_torch_tokenizers.py).  ``regex`` and ``ftfy``
are used when installed.
"""

from __future__ import annotations

import functools
import gzip
import html
import json
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

try:  # CLIP's token pattern needs unicode property classes
    import regex as _re

    _PAT = _re.compile(
        r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+""",
        _re.IGNORECASE,
    )
except ImportError:  # ASCII approximation (class names are ASCII)
    import re as _re

    _PAT = _re.compile(
        r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[a-z]+|[0-9]|[^\s a-z0-9]+""",
        _re.IGNORECASE,
    )

try:
    import ftfy

    _fix_text = ftfy.fix_text
except ImportError:
    _fix_text = None


@functools.lru_cache()
def bytes_to_unicode() -> Dict[int, str]:
    """GPT-2/CLIP reversible byte→printable-unicode map."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("¡"), ord("¬") + 1))
        + list(range(ord("®"), ord("ÿ") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _get_pairs(word: Tuple[str, ...]):
    pairs = set()
    prev = word[0]
    for ch in word[1:]:
        pairs.add((prev, ch))
        prev = ch
    return pairs


def _whitespace_clean(text: str) -> str:
    import re

    return re.sub(r"\s+", " ", text).strip()


class CLIPBPETokenizer:
    """OpenAI-CLIP BPE.  ``merges``: ordered (a, b) pairs; ``vocab``:
    token→id (derived from merges when absent, OpenAI layout)."""

    SOT = "<|startoftext|>"
    EOT = "<|endoftext|>"

    def __init__(
        self,
        merges: Sequence[Tuple[str, str]],
        vocab: Optional[Dict[str, int]] = None,
        context_length: int = 77,
    ):
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        self.bpe_ranks = {tuple(m): i for i, m in enumerate(merges)}
        if vocab is None:
            # OpenAI derivation: 256 bytes + 256 byte</w> + merge outputs + specials
            toks = list(bytes_to_unicode().values())
            toks = toks + [t + "</w>" for t in toks]
            toks += ["".join(m) for m in merges]
            toks += [self.SOT, self.EOT]
            if len(set(toks)) != len(toks):
                raise ValueError(
                    "merge outputs collide with base tokens — invalid merges"
                )
            vocab = {t: i for i, t in enumerate(toks)}
        self.encoder = dict(vocab)
        self.decoder = {v: k for k, v in self.encoder.items()}
        self.cache = {self.SOT: self.SOT, self.EOT: self.EOT}
        self.context_length = context_length

    # ---------------------------------------------------------------- assets
    @classmethod
    def from_files(
        cls,
        merges_path: str,
        vocab_path: Optional[str] = None,
        context_length: int = 77,
    ) -> "CLIPBPETokenizer":
        opener = gzip.open if merges_path.endswith(".gz") else open
        with opener(merges_path, "rt", encoding="utf-8") as f:
            lines = f.read().split("\n")
        # skip version header / trailing blanks; OpenAI's 16e6 file uses
        # rows 1..48894+1 (clip/simple_tokenizer.py)
        if lines and (lines[0].startswith("#version") or "bpe" in lines[0]):
            lines = lines[1:]
        merges = [tuple(l.split()) for l in lines if len(l.split()) == 2]
        vocab = None
        if vocab_path and os.path.exists(vocab_path):
            with open(vocab_path, "r", encoding="utf-8") as f:
                vocab = json.load(f)
        return cls(merges, vocab, context_length)

    # ------------------------------------------------------------------- bpe
    def bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = _get_pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word: List[str] = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if i < len(word) - 1 and word[i] == first and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = _get_pairs(word)
        out = " ".join(word)
        self.cache[token] = out
        return out

    def encode(self, text: str) -> List[int]:
        """Text → BPE ids (no specials)."""
        if _fix_text is not None:
            text = _fix_text(text)
        text = html.unescape(html.unescape(text))
        text = _whitespace_clean(text).lower()
        ids: List[int] = []
        for token in _PAT.findall(text):
            token = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            ids.extend(self.encoder[t] for t in self.bpe(token).split(" "))
        return ids

    def decode(self, ids: Sequence[int]) -> str:
        text = "".join(self.decoder[int(i)] for i in ids)
        raw = bytearray(self.byte_decoder[c] for c in text if c in self.byte_decoder)
        return raw.decode("utf-8", errors="replace").replace("</w>", " ").strip()

    def __call__(self, texts: Sequence[str]) -> np.ndarray:
        """CLIP ``tokenize()``: [N, context_length] int32 with SOT/EOT,
        zero-padded, truncated keeping EOT last."""
        sot, eot = self.encoder[self.SOT], self.encoder[self.EOT]
        out = np.zeros((len(texts), self.context_length), np.int32)
        for i, t in enumerate(texts):
            ids = [sot] + self.encode(t) + [eot]
            if len(ids) > self.context_length:
                ids = ids[: self.context_length]
                ids[-1] = eot
            out[i, : len(ids)] = ids
        return out

    @property
    def vocab_size(self) -> int:
        return len(self.encoder)

    @property
    def eot_id(self) -> int:
        return self.encoder[self.EOT]


def write_hf_assets(tokenizer: CLIPBPETokenizer, out_dir: str):
    """Emit vocab.json + merges.txt loadable by transformers.CLIPTokenizer
    (used by the golden parity test and for interop)."""
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "vocab.json"), "w", encoding="utf-8") as f:
        json.dump(tokenizer.encoder, f, ensure_ascii=False)
    merges = sorted(tokenizer.bpe_ranks.items(), key=lambda kv: kv[1])
    with open(os.path.join(out_dir, "merges.txt"), "w", encoding="utf-8") as f:
        f.write("#version: 0.2\n")
        for (a, b), _ in merges:
            f.write(f"{a} {b}\n")
    return out_dir
