"""Pure-Python SentencePiece tokenizer for Llama-family ``.model`` files
(counterpart of ``openpsg_tpu/models/relation/sp_tokenizer.py``, a copy:
the port imports nothing of the JAX package).

The reference tokenizes LLM prompts with SentencePiece
(kings_sgg/models/commons/llama_tokenizer.py).  This module reads the
published ``tokenizer.model`` assets with no dependency:

  * a minimal protobuf wire-format reader for SentencePiece's
    ``ModelProto`` (pieces + trainer ids + normalizer flags);
  * the SP-BPE greedy merge encoder (highest-score adjacent pair first,
    leftmost on ties — bpe_model.cc semantics) and the unigram Viterbi
    encoder, selected by the model's ``model_type``;
  * SP normalization: ``▁`` whitespace escaping, optional dummy prefix,
    byte-fallback for out-of-vocab characters (``<0xXX>`` pieces);
  * the reference wrapper's special-token behavior: ids appended past
    vocab end, encode/decode split text around special-token substrings
    (llama_tokenizer.py:38-122).

Interface matches :class:`openpsg_tpu_torch.models.relation.tokenizer.
WordTokenizer` (``vocab_size``, ``pad_id/bos_id/eos_id``, ``encode``,
``encode_batch``, ``decode``) so ``PSGv4(tokenizer=...)`` accepts it
unchanged.  ``build_sp_model_bytes`` and ``build_toy_llama_tokenizer``
make toy models for tests and the smoke run, with no download.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

SPACE = "▁"  # '▁', SentencePiece whitespace escape

# piece types (sentencepiece_model.proto: SentencePiece.Type)
NORMAL, UNKNOWN, CONTROL, USER_DEFINED, UNUSED, BYTE = 1, 2, 3, 4, 5, 6
# model types (TrainerSpec.ModelType)
UNIGRAM, BPE = 1, 2


# --------------------------------------------------------------------------
# protobuf wire format (read + write just what ModelProto needs)
# --------------------------------------------------------------------------

def _read_varint(data: bytes, i: int) -> Tuple[int, int]:
    out = shift = 0
    while True:
        b = data[i]
        i += 1
        out |= (b & 0x7F) << shift
        if not b & 0x80:
            return out, i
        shift += 7


def _signed(v: int) -> int:
    """proto int32/int64 negative values arrive as 64-bit two's complement."""
    return v - (1 << 64) if v >= (1 << 63) else v


def _fields(data: bytes):
    """Yield (field_number, wire_type, value) triples of one message."""
    i = 0
    n = len(data)
    while i < n:
        key, i = _read_varint(data, i)
        field, wire = key >> 3, key & 7
        if wire == 0:
            v, i = _read_varint(data, i)
        elif wire == 1:
            v, i = data[i : i + 8], i + 8
        elif wire == 2:
            ln, i = _read_varint(data, i)
            v, i = data[i : i + ln], i + ln
        elif wire == 5:
            v, i = data[i : i + 4], i + 4
        else:  # groups (3/4) never appear in ModelProto
            raise ValueError(f"unsupported wire type {wire}")
        yield field, wire, v


def _write_varint(v: int) -> bytes:
    if v < 0:
        v += 1 << 64
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _write_field(field: int, wire: int, payload: bytes) -> bytes:
    head = _write_varint((field << 3) | wire)
    if wire == 2:
        return head + _write_varint(len(payload)) + payload
    return head + payload


def parse_model_proto(data: bytes) -> dict:
    """→ {pieces: [(piece, score, type)], model_type, unk/bos/eos/pad_id,
    add_dummy_prefix, remove_extra_whitespaces}."""
    pieces: List[Tuple[str, float, int]] = []
    meta = {
        # proto2 default for TrainerSpec.model_type is UNIGRAM(=1)
        "model_type": UNIGRAM,
        "unk_id": 0,
        "bos_id": 1,
        "eos_id": 2,
        "pad_id": -1,
        "add_dummy_prefix": True,
        "remove_extra_whitespaces": True,
    }
    for field, wire, v in _fields(data):
        if field == 1 and wire == 2:  # repeated SentencePiece
            piece, score, ptype = "", 0.0, NORMAL
            for f2, w2, v2 in _fields(v):
                if f2 == 1:
                    piece = v2.decode("utf-8")
                elif f2 == 2:
                    score = float(np.frombuffer(v2, "<f4")[0])
                elif f2 == 3:
                    ptype = v2
            pieces.append((piece, score, ptype))
        elif field == 2 and wire == 2:  # TrainerSpec
            for f2, w2, v2 in _fields(v):
                if f2 == 3:
                    meta["model_type"] = v2
                elif f2 == 40:
                    meta["unk_id"] = _signed(v2)
                elif f2 == 41:
                    meta["bos_id"] = _signed(v2)
                elif f2 == 42:
                    meta["eos_id"] = _signed(v2)
                elif f2 == 43:
                    meta["pad_id"] = _signed(v2)
        elif field == 3 and wire == 2:  # NormalizerSpec
            for f2, w2, v2 in _fields(v):
                if f2 == 3:
                    meta["add_dummy_prefix"] = bool(v2)
                elif f2 == 4:
                    meta["remove_extra_whitespaces"] = bool(v2)
    meta["pieces"] = pieces
    return meta


def build_sp_model_bytes(
    pieces: Sequence[Tuple[str, float, int]],
    *,
    model_type: int = BPE,
    unk_id: int = 0,
    bos_id: int = 1,
    eos_id: int = 2,
    pad_id: int = -1,
    add_dummy_prefix: bool = True,
) -> bytes:
    """Serialize a toy ModelProto (tests / synthetic vocabularies)."""
    out = bytearray()
    for piece, score, ptype in pieces:
        body = (
            _write_field(1, 2, piece.encode("utf-8"))
            + _write_field(2, 5, np.float32(score).tobytes())
            + _write_varint((3 << 3) | 0) + _write_varint(ptype)
        )
        out += _write_field(1, 2, body)
    trainer = (
        _write_varint((3 << 3) | 0) + _write_varint(model_type)
        + _write_varint((40 << 3) | 0) + _write_varint(unk_id)
        + _write_varint((41 << 3) | 0) + _write_varint(bos_id)
        + _write_varint((42 << 3) | 0) + _write_varint(eos_id)
        + _write_varint((43 << 3) | 0) + _write_varint(pad_id)
    )
    out += _write_field(2, 2, trainer)
    norm = _write_varint((3 << 3) | 0) + _write_varint(int(add_dummy_prefix))
    out += _write_field(3, 2, norm)
    return bytes(out)


# --------------------------------------------------------------------------
# the tokenizer
# --------------------------------------------------------------------------

class SentencePieceTokenizer:
    """Reads a SentencePiece ``.model`` file; WordTokenizer interface plus
    the reference's special-token extension (ids past vocab end)."""

    def __init__(self, model_bytes: bytes):
        m = parse_model_proto(model_bytes)
        self.pieces = m["pieces"]
        self.model_type = m["model_type"]
        self.add_dummy_prefix = m["add_dummy_prefix"]
        self.remove_extra_whitespaces = m["remove_extra_whitespaces"]
        self._unk = m["unk_id"]
        self._bos = m["bos_id"]
        self._eos = m["eos_id"]
        self._pad = m["pad_id"]
        self.ptoi: Dict[str, int] = {}
        self.scores: Dict[str, float] = {}
        # segmentation candidates: NORMAL pieces only — CONTROL/BYTE piece
        # strings appearing literally in text must NOT produce their ids
        # (e.g. a prompt containing "</s>" must not emit a real EOS)
        self._seg_scores: Dict[str, float] = {}
        self._byte_ids: Dict[int, int] = {}
        for i, (piece, score, ptype) in enumerate(self.pieces):
            if piece not in self.ptoi:
                self.ptoi[piece] = i
            self.scores[piece] = score
            if ptype == NORMAL:
                self._seg_scores[piece] = score
            if ptype == BYTE:
                self._byte_ids[int(piece[1:-1], 16)] = i  # "<0xAB>"
        self._types = [p[2] for p in self.pieces]
        # SentencePiece scores an unknown single char min_score - unk_penalty
        # (unigram_model.cc kUnkPenalty=10), not a flat constant
        self._unk_char_score = (
            min(self._seg_scores.values(), default=0.0) - 10.0
        )
        # special tokens appended past vocab end (llama_tokenizer.py:38-47)
        self.special_ttoi: Dict[str, int] = {}
        self.special_itot: Dict[int, str] = {}

    @classmethod
    def from_file(cls, path: str) -> "SentencePieceTokenizer":
        with open(path, "rb") as f:
            return cls(f.read())

    def add_special_tokens(self, tokens: Sequence[str]) -> None:
        for i, t in enumerate(tokens):
            tid = len(self.pieces) + len(self.special_ttoi)
            self.special_ttoi[t] = tid
            self.special_itot[tid] = t

    # -- WordTokenizer interface ------------------------------------------
    @property
    def vocab_size(self) -> int:
        return len(self.pieces) + len(self.special_ttoi)

    @property
    def pad_id(self) -> int:
        return self._pad if self._pad >= 0 else self._unk  # pad=unk (:105)

    @property
    def bos_id(self) -> int:
        return self._bos

    @property
    def eos_id(self) -> int:
        return self._eos

    # -- encoding ----------------------------------------------------------
    def _normalize(self, text: str) -> str:
        if self.remove_extra_whitespaces:
            text = " ".join(text.split())
        if self.add_dummy_prefix and text:
            text = " " + text
        return text.replace(" ", SPACE)

    def _bpe_symbols(self, text: str) -> List[str]:
        syms = list(text)
        while len(syms) > 1:
            best_score, best_i = None, -1
            for i in range(len(syms) - 1):
                cand = syms[i] + syms[i + 1]
                s = self._seg_scores.get(cand)  # merges: NORMAL pieces only
                if s is None:
                    continue
                if best_score is None or s > best_score:
                    best_score, best_i = s, i
            if best_i < 0:
                break
            syms[best_i : best_i + 2] = [syms[best_i] + syms[best_i + 1]]
        return syms

    def _unigram_symbols(self, text: str) -> List[str]:
        # Viterbi over character positions maximizing Σ piece scores;
        # unknown chars get a large penalty so known pieces always win.
        n = len(text)
        if n == 0:
            return []
        NEG = -1e18
        best = [NEG] * (n + 1)
        back: List[Tuple[int, str]] = [(0, "")] * (n + 1)
        best[0] = 0.0
        maxlen = max((len(p) for p in self._seg_scores), default=1)
        unk_score = self._unk_char_score
        for i in range(n):
            if best[i] <= NEG:
                continue
            for j in range(i + 1, min(n, i + maxlen) + 1):
                cand = text[i:j]
                s = self._seg_scores.get(cand)  # NORMAL pieces only
                if s is None:
                    if j - i > 1:
                        continue
                    s = unk_score  # unknown single char
                if best[i] + s > best[j]:
                    best[j] = best[i] + s
                    back[j] = (i, cand)
        out: List[str] = []
        j = n
        while j > 0:
            i, piece = back[j]
            out.append(piece or text[j - 1 : j])
            j = i if piece else j - 1
        return out[::-1]

    def _piece_ids(self, piece: str) -> List[int]:
        pid = self.ptoi.get(piece)
        if pid is not None and self._types[pid] != UNUSED:
            return [pid]
        if self._byte_ids:  # byte fallback
            return [
                self._byte_ids.get(b, self._unk) for b in piece.encode("utf-8")
            ]
        return [self._unk]

    def _encode_chunk(self, text: str) -> List[int]:
        text = self._normalize(text)
        if not text:
            return []
        syms = (
            self._unigram_symbols(text)
            if self.model_type == UNIGRAM
            else self._bpe_symbols(text)
        )
        out: List[int] = []
        for s in syms:
            out.extend(self._piece_ids(s))
        return out

    def encode(self, text: str, add_bos: bool = False, add_eos: bool = False) -> List[int]:
        # split around special-token substrings (llama_tokenizer.py:69-102)
        ids: List[int] = []
        rest = text
        while rest:
            hit, hit_pos = None, len(rest)
            for t in self.special_ttoi:
                p = rest.find(t)
                if p != -1 and (p < hit_pos or (p == hit_pos and len(t) > len(hit or ""))):
                    hit, hit_pos = t, p
            if hit is None:
                ids.extend(self._encode_chunk(rest))
                break
            ids.extend(self._encode_chunk(rest[:hit_pos]))
            ids.append(self.special_ttoi[hit])
            rest = rest[hit_pos + len(hit):]
        if add_bos:
            ids = [self._bos] + ids
        if add_eos:
            ids = ids + [self._eos]
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

    # -- decoding ----------------------------------------------------------
    def _decode_pieces(self, ids: Sequence[int]) -> str:
        out: List[str] = []
        byte_buf = bytearray()

        def flush():
            if byte_buf:
                out.append(byte_buf.decode("utf-8", errors="replace"))
                byte_buf.clear()

        for i in ids:
            piece, _, ptype = self.pieces[i]
            if ptype == BYTE:
                byte_buf.append(int(piece[1:-1], 16))
                continue
            flush()
            if ptype == CONTROL:
                continue
            if ptype == UNKNOWN:
                # render unk visibly (SentencePiece's unk_surface " ⁇ "):
                # a generated unk must not vanish
                out.append(" ⁇ ")
                continue
            out.append(piece)
        flush()
        text = "".join(out).replace(SPACE, " ")
        return text[1:] if text.startswith(" ") else text

    def decode(self, ids: Sequence[int], stop_at_eos: bool = True) -> str:
        # split at special ids (llama_tokenizer.py:104-122), honoring the
        # WordTokenizer contract (skip pads, stop at eos)
        parts: List[str] = []
        chunk: List[int] = []
        for i in ids:
            i = int(i)
            # skip pads only when the model declares a REAL pad id; for
            # Llama-layout models pad_id falls back to unk_id, and genuinely
            # generated unks must stay visible
            if self._pad >= 0 and i == self._pad:
                continue
            if i == self._eos and stop_at_eos:
                break
            if i in self.special_itot:
                parts.append(self._decode_pieces(chunk))
                parts.append(self.special_itot[i])
                chunk = []
            elif i == self._bos:
                continue
            elif 0 <= i < len(self.pieces):
                chunk.append(i)
        parts.append(self._decode_pieces(chunk))
        return "".join(parts)


def build_toy_llama_tokenizer(words: Sequence[str]) -> SentencePieceTokenizer:
    """A miniature Llama-layout SP model over ``words``: control pieces at
    ids 0-2 (unk/bos/eos), byte pieces, then whole-word `▁word` pieces and
    their prefixes as merge steps — enough to exercise every code path
    without a trained asset."""
    pieces: List[Tuple[str, float, int]] = [
        ("<unk>", 0.0, UNKNOWN), ("<s>", 0.0, CONTROL), ("</s>", 0.0, CONTROL),
    ]
    for b in range(256):
        pieces.append((f"<0x{b:02X}>", 0.0, BYTE))
    seen = {p for p, _, _ in pieces}
    score = -1.0
    for w in words:
        for chunk in (SPACE + w, w):
            for ln in range(2, len(chunk) + 1):
                sub = chunk[:ln]
                if sub not in seen:
                    seen.add(sub)
                    pieces.append((sub, score, NORMAL))
                    score -= 1.0
    return SentencePieceTokenizer(
        build_sp_model_bytes(pieces, model_type=BPE, unk_id=0, bos_id=1,
                             eos_id=2, pad_id=-1)
    )
