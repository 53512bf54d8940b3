"""A pure-Python SentencePiece model reader and unigram encoder.

Counterpart of torcheasyrec_tpu/features/spiece.py. TorchEasyRec's
TokenizeFeature takes ``tokenizer_type: "sentencepiece"`` with a
serialized ``spiece.model``; the sentencepiece package is not needed for
it, since this module implements the two pieces TokenizeFeature uses:

1. a minimal protobuf wire-format reader for ModelProto, of the fields
   used only: ``pieces`` (field 1: piece, score, type) and
   ``trainer_spec.unk_id`` (field 2, field 40);
2. unigram-LM Viterbi segmentation (sentencepiece's default algorithm):
   the best path over the pieces' log-probabilities, spaces turned into
   the U+2581 word-boundary marker with ``add_dummy_prefix``; a
   character outside the vocabulary emits ``unk_id``. BPE-type models
   carry per-piece scores too, so the same Viterbi serves both.

It encodes only; it trains nothing.
"""

import struct
from typing import Dict, List, Tuple

_WORD_SEP = "▁"  # ▁

# piece types (sentencepiece_model.proto ModelProto.SentencePiece.Type)
_NORMAL = 1
_UNKNOWN = 2
_CONTROL = 3
_USER_DEFINED = 4
_BYTE = 6


def _read_varint(buf: bytes, i: int) -> Tuple[int, int]:
    x = 0
    shift = 0
    while True:
        b = buf[i]
        i += 1
        x |= (b & 0x7F) << shift
        if not b & 0x80:
            return x, i
        shift += 7


def _fields(buf: bytes):
    """Yield (field_number, wire_type, value) over a message buffer.
    value: int for varint, bytes for length-delimited, raw 4/8 bytes
    for fixed."""
    i = 0
    n = len(buf)
    while i < n:
        key, i = _read_varint(buf, i)
        fn, wt = key >> 3, key & 7
        if wt == 0:
            v, i = _read_varint(buf, i)
        elif wt == 2:
            ln, i = _read_varint(buf, i)
            v = buf[i : i + ln]
            i += ln
        elif wt == 5:
            v = buf[i : i + 4]
            i += 4
        elif wt == 1:
            v = buf[i : i + 8]
            i += 8
        else:  # groups (3/4) don't appear in ModelProto
            raise ValueError(f"unsupported wire type {wt}")
        yield fn, wt, v


class SentencePieceModel:
    """Loaded spm model: vocab + scores + unigram Viterbi encode()."""

    def __init__(
        self,
        pieces: List[Tuple[str, float, int]],
        unk_id: int = 0,
    ) -> None:
        self.pieces = pieces
        self.unk_id = unk_id
        self._index: Dict[str, int] = {}
        self._scores: Dict[str, float] = {}
        self._max_len = 1
        for i, (p, score, ptype) in enumerate(pieces):
            if ptype in (_CONTROL, _UNKNOWN):
                if ptype == _UNKNOWN:
                    self.unk_id = i
                continue
            if p not in self._index:
                self._index[p] = i
                self._scores[p] = score
                self._max_len = max(self._max_len, len(p))

    @classmethod
    def load(cls, path: str) -> "SentencePieceModel":
        with open(path, "rb") as f:
            buf = f.read()
        pieces: List[Tuple[str, float, int]] = []
        unk_id = 0
        for fn, wt, v in _fields(buf):
            if fn == 1 and wt == 2:  # repeated SentencePiece
                piece, score, ptype = "", 0.0, _NORMAL
                for pfn, pwt, pv in _fields(v):
                    if pfn == 1 and pwt == 2:
                        piece = pv.decode("utf-8", "replace")
                    elif pfn == 2 and pwt == 5:
                        score = struct.unpack("<f", pv)[0]
                    elif pfn == 3 and pwt == 0:
                        ptype = pv
                pieces.append((piece, score, ptype))
            elif fn == 2 and wt == 2:  # TrainerSpec
                for tfn, twt, tv in _fields(v):
                    if tfn == 40 and twt == 0:  # unk_id
                        unk_id = tv
        return cls(pieces, unk_id=unk_id)

    def get_vocab_size(self) -> int:
        return len(self.pieces)

    def piece_to_id(self, piece: str) -> int:
        return self._index.get(piece, self.unk_id)

    def encode(self, text: str) -> List[int]:
        """Unigram Viterbi over the piece vocabulary (spm defaults:
        add_dummy_prefix + whitespace -> U+2581)."""
        if not text:
            return []
        s = _WORD_SEP + text.replace(" ", _WORD_SEP)
        n = len(s)
        # best[i] = (score, backpointer, piece_id) for prefix s[:i]
        NEG = -1e18
        best_score = [NEG] * (n + 1)
        back = [0] * (n + 1)
        best_id = [0] * (n + 1)
        best_score[0] = 0.0
        # unknown single characters pay a fixed penalty below every
        # real piece (spm's unk_score = min_score - 10)
        unk_penalty = (
            min(self._scores.values()) - 10.0 if self._scores else -10.0
        )
        for i in range(n):
            if best_score[i] <= NEG / 2:
                continue
            hi = min(n, i + self._max_len)
            for j in range(i + 1, hi + 1):
                sub = s[i:j]
                sc = self._scores.get(sub)
                if sc is None:
                    continue
                t = best_score[i] + sc
                if t > best_score[j]:
                    best_score[j] = t
                    back[j] = i
                    best_id[j] = self._index[sub]
            # unk fallback: single char
            t = best_score[i] + unk_penalty
            if t > best_score[i + 1]:
                best_score[i + 1] = t
                back[i + 1] = i
                best_id[i + 1] = -1  # unk marker
        out: List[int] = []
        j = n
        while j > 0:
            i = back[j]
            pid = best_id[j]
            out.append(self.unk_id if pid < 0 else pid)
            j = i
        out.reverse()
        return out


class SpmTokenizerAdapter:
    """Duck-types the two methods TokenizeFeature uses from the
    HuggingFace ``tokenizers.Tokenizer`` API."""

    class _Enc:
        def __init__(self, ids: List[int]) -> None:
            self.ids = ids

    def __init__(self, model: SentencePieceModel) -> None:
        self.model = model

    @classmethod
    def from_file(cls, path: str) -> "SpmTokenizerAdapter":
        return cls(SentencePieceModel.load(path))

    def get_vocab_size(self) -> int:
        return self.model.get_vocab_size()

    def encode(self, text: str) -> "SpmTokenizerAdapter._Enc":
        return self._Enc(self.model.encode(text))
