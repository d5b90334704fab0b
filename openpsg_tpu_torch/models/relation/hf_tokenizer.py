"""HF tokenizer adapter (counterpart of
``openpsg_tpu/models/relation/hf_tokenizer.py``): a drop-in for
WordTokenizer when real assets exist.

The reference tokenizes Q-Former instructions with BERT wordpiece and LLM
prompts with Llama SentencePiece (relation_transformer_head_v4.py:85-86,
104-105).  This adapter wraps any ``transformers`` tokenizer behind the
same interface as :class:`openpsg_tpu_torch.models.relation.tokenizer.
WordTokenizer` (``vocab_size``, ``pad_id/bos_id/eos_id``, ``encode``,
``encode_batch`` with left/right padding, ``decode``):

    tok = HFTokenizer.from_pretrained("/path/to/llama-tokenizer")
    model = PSGv4(cfg, tokenizer=tok)

``transformers`` is imported only by :meth:`HFTokenizer.from_pretrained`.
Static shapes are preserved: ``encode_batch`` always emits [B, max_len].
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np


class HFTokenizer:
    def __init__(self, hf_tokenizer):
        self.tok = hf_tokenizer
        # mirror the reference's pad=unk fallback (:105)
        if self.tok.pad_token is None:
            self.tok.pad_token = (
                self.tok.unk_token or self.tok.eos_token or "[PAD]"
            )

    @classmethod
    def from_pretrained(cls, path: str, **kw) -> "HFTokenizer":
        from transformers import AutoTokenizer

        return cls(AutoTokenizer.from_pretrained(path, **kw))

    # -- WordTokenizer interface -----------------------------------------
    @property
    def vocab_size(self) -> int:
        return len(self.tok)

    @property
    def pad_id(self) -> int:
        return int(self.tok.pad_token_id)

    @property
    def bos_id(self) -> int:
        bid = self.tok.bos_token_id
        return int(bid if bid is not None else self.tok.cls_token_id or 0)

    @property
    def eos_id(self) -> int:
        eid = self.tok.eos_token_id
        return int(eid if eid is not None else self.tok.sep_token_id or 0)

    def encode(self, text: str, add_bos: bool = False, add_eos: bool = False) -> List[int]:
        ids = self.tok.encode(text, add_special_tokens=False)
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
        B = len(texts)
        ids = np.full((B, max_len), self.pad_id, np.int32)
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
            if i == self.eos_id and stop_at_eos:
                break
            out.append(i)
        return self.tok.decode(out, skip_special_tokens=True).strip()
