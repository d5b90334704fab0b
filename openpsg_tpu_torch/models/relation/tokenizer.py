"""Host-side tokenizers for relation prompts (plain-Python copy of
``openpsg_tpu/models/relation/tokenizer.py``; the port imports nothing of
the JAX package).

The reference tokenizes two kinds of strings per image (SURVEY.md §2.3):
  * Q-Former instructions "Is there a relation between {a} and {b}?"
    (relation_transformer_head_v4.py:25, 146-152) via a BERT wordpiece
    tokenizer, and
  * LLM prompts "What are the relations between {a} and {b}? Assistant: "
    plus label strings " {rel} </s>" via Llama's SentencePiece
    (relation_transformer_head_v4.py:35, 260-285).

The prompt vocabulary is tiny and closed: template words + 133 class names
+ 56 predicates.  ``WordTokenizer`` therefore builds a deterministic
word-level vocab over exactly that closed set, producing static-shape
[batch, max_len] id arrays — no vocab assets needed, fully reproducible,
and sufficient to train this framework's own models end-to-end.  HF
tokenizer files can be slotted in later for checkpoint-parity work (the
tokenizer interface is the same: ``encode_batch`` → ids + mask).
"""

from __future__ import annotations

import re
from typing import Dict, Iterable, List, Sequence, Tuple

import numpy as np

PAD, UNK, BOS, EOS = "[PAD]", "[UNK]", "<s>", "</s>"


def _words(text: str) -> List[str]:
    return re.findall(r"[a-z0-9']+|[?.,!]", text.lower())


class WordTokenizer:
    """Deterministic closed-vocab word tokenizer.

    ids: 0=PAD, 1=UNK, 2=BOS, 3=EOS, then sorted vocabulary words.
    """

    def __init__(self, texts: Iterable[str]):
        vocab = sorted({w for t in texts for w in _words(t)})
        self.itos: List[str] = [PAD, UNK, BOS, EOS] + vocab
        self.stoi: Dict[str, int] = {w: i for i, w in enumerate(self.itos)}

    @property
    def vocab_size(self) -> int:
        return len(self.itos)

    @property
    def pad_id(self) -> int:
        return 0

    @property
    def bos_id(self) -> int:
        return 2

    @property
    def eos_id(self) -> int:
        return 3

    def encode(self, text: str, add_bos: bool = False, add_eos: bool = False) -> List[int]:
        ids = [self.stoi.get(w, 1) for w in _words(text)]
        if add_bos:
            ids = [self.bos_id] + ids
        if add_eos:
            ids = ids + [self.eos_id]
        return ids

    def encode_batch(
        self,
        texts: Sequence[str],
        max_len: int,
        add_bos: bool = False,
        add_eos: bool = False,
        padding_side: str = "right",
    ) -> Tuple[np.ndarray, np.ndarray]:
        """→ (ids [B, max_len] int32, mask [B, max_len] bool).

        ``padding_side='left'`` mirrors the reference's left-padded LLM
        prompts (relation_transformer_head_v4.py:262)."""
        B = len(texts)
        ids = np.zeros((B, max_len), np.int32)
        mask = np.zeros((B, max_len), bool)
        for i, t in enumerate(texts):
            e = self.encode(t, add_bos, add_eos)[:max_len]
            if padding_side == "right":
                ids[i, : len(e)] = e
                mask[i, : len(e)] = True
            else:
                ids[i, max_len - len(e):] = e
                mask[i, max_len - len(e):] = True
        return ids, mask

    def decode(self, ids: Sequence[int], stop_at_eos: bool = True) -> str:
        out = []
        for i in ids:
            i = int(i)
            if i == self.pad_id:
                continue
            if i == self.eos_id:
                if stop_at_eos:
                    break
                out.append(EOS)
                continue
            if i == self.bos_id:
                continue
            out.append(self.itos[i] if 0 <= i < len(self.itos) else UNK)
        return " ".join(out)


def build_prompt_tokenizer(extra_texts: Sequence[str] = ()) -> WordTokenizer:
    """Tokenizer covering the full closed prompt vocabulary."""
    from openpsg_tpu_torch.data.vocab import OBJECT_CLASSES, RELATION_CLASSES

    base = [
        "Is there a relation between and ?",
        "What are the relations between and ? Assistant: ",
    ]
    return WordTokenizer(list(base) + list(OBJECT_CLASSES) + list(RELATION_CLASSES) + list(extra_texts))
