"""IdFeature: categorical id feature.

Counterpart of torcheasyrec_tpu/features/id_feature.py. In FG_NONE mode
the ids arrive encoded and the base class parses them. In FG_NORMAL mode
``_parse_fg`` maps the input through ``hash_bucket_size`` (FNV-1a of the
token), ``num_buckets`` (``int(token)``, clipped), or a vocab (list, dict
or file, which take precedence over the buckets): a string cell splits on
``separator`` into tokens (a weighted feature's tokens are ``id:weight``),
a sequence cell splits into steps on the sequence delimiter first, and an
integer column maps its values. Nulls and empty cells read
``default_value`` where it is set, else give no id. The hashed string and
sequence paths run in C++ (``fg.split_hash_arrow``,
``fg.seq_split_hash_arrow``) where the column allows it, and the integer
path hashes the decimal strings in C++ (``fg.hash_ints_mod``).
"""

from typing import Any, Dict, Optional

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc

from torcheasyrec_tpu_torch import fg as fg_native
from torcheasyrec_tpu_torch.features.feature import (
    BaseFeature,
    SequenceSparseData,
    SparseData,
)


def _is_int(s: str) -> bool:
    """Whether ``int(s)`` reads ``s`` (decimal digits, a sign, spaces)."""
    t = s.strip()
    return t[1:].isdigit() if t[:1] in "+-" and t else t.isdigit()


class IdFeature(BaseFeature):
    @property
    def is_sparse(self) -> bool:
        return True

    def _int_ids_vectorized(self, feat: pa.Array, default: str
                            ) -> Optional[SparseData]:
        """The ids of an integer column where the buckets alone map it (no
        vocab: a vocab takes precedence and maps ``str(value)``), else
        None. ``num_buckets`` clips; ``hash_bucket_size`` hashes the
        decimal strings in C++, the ids of the string path."""
        c = self.config
        if self.vocab_table_and_oov() is not None or not (
                getattr(c, "num_buckets", 0)
                or getattr(c, "hash_bucket_size", 0)):
            return None
        if pa.types.is_uint64(feat.type) or (default
                                              and not _is_int(default)):
            # values past int64, or a default that is no integer: the
            # token path, which gives these the same ids
            return None
        if default:
            feat = feat.cast(pa.int64()).fill_null(int(default))
        nulls = feat.is_null().to_numpy(zero_copy_only=False)
        lengths = (~nulls).astype(np.int32)
        vals = feat.drop_null().cast(pa.int64()).to_numpy(
            zero_copy_only=False)
        if getattr(c, "num_buckets", 0):
            ids = np.clip(vals, 0, int(c.num_buckets) - 1)
        else:
            ids = fg_native.hash_ints_mod(vals, int(c.hash_bucket_size))
        return SparseData(self.name, ids, lengths, None)

    def _parse_fg(self, input_data: Dict[str, pa.Array],
                  is_training: bool) -> Any:
        feat = self._input_column(input_data)
        c = self.config
        sep = getattr(c, "separator", "\x1d") or "\x1d"
        default = getattr(c, "default_value", "")
        if self.is_sequence:
            return self._parse_sequence(feat, sep, default)

        weights = None
        if pa.types.is_string(feat.type) or pa.types.is_large_string(
                feat.type):
            is_empty = pc.equal(feat, pa.scalar(""))
            feat = pc.if_else(is_empty, pa.nulls(len(feat)), feat)
            if default:
                feat = feat.fill_null(default)
            if (not self.is_weighted and getattr(c, "hash_bucket_size", 0)
                    and fg_native.split_hash_ok(feat, sep)):
                values, lengths = fg_native.split_hash_arrow(
                    feat, sep, int(c.hash_bucket_size))
                return SparseData(self.name, values, lengths, None)
            nulls = feat.is_null().to_numpy(zero_copy_only=False)
            lf = pc.split_pattern(feat.fill_null(""), sep)
            offs = lf.offsets.to_numpy()
            lengths = np.where(nulls, 0, offs[1:] - offs[:-1]).astype(
                np.int32)
            keep = np.repeat(~nulls, offs[1:] - offs[:-1])
            tokens = np.asarray(
                [t for t, k in zip(lf.values.to_pylist(), keep) if k],
                dtype=object)
            if self.is_weighted and len(tokens):
                pairs = [str(t).split(":") for t in tokens]
                tokens = np.asarray([p[0] for p in pairs], dtype=object)
                weights = np.asarray(
                    [float(p[1]) if len(p) > 1 else 1.0 for p in pairs],
                    dtype=np.float32)
        else:
            if pa.types.is_integer(feat.type):
                fast = self._int_ids_vectorized(feat, default)
                if fast is not None:
                    return fast
            if default:
                if pa.types.is_string(feat.type) or pa.types.is_null(
                        feat.type):
                    feat = feat.fill_null(default)
                else:
                    # a string default over a non-string column: compare
                    # in string space (str(t))
                    feat = feat.cast(pa.string()).fill_null(default)
            vals = feat.to_pylist()
            tokens = np.asarray([v for v in vals if v is not None],
                                dtype=object)
            lengths = np.asarray([v is not None for v in vals], np.int32)
        ids = (self._vocab_to_ids(tokens) if len(tokens)
               else np.zeros((0,), np.int64))
        return SparseData(self.name, ids, lengths, weights)

    def _parse_sequence(self, feat: pa.Array, sep: str, default: str
                        ) -> SequenceSparseData:
        """Steps on the sequence delimiter, tokens on ``sep``; a null or
        empty row is an empty sequence (or ``default``)."""
        c = self.config
        delim = self.effective_sequence_delim
        feat = feat.cast(pa.string(), safe=False)
        is_empty = pc.equal(feat, pa.scalar(""))
        feat = pc.if_else(is_empty, pa.nulls(len(feat)), feat)
        if default:
            feat = feat.fill_null(default)
        if getattr(c, "hash_bucket_size", 0) and not self.is_weighted:
            filled = feat.fill_null("")
            if fg_native.seq_split_hash_ok(filled, delim, sep):
                vals, tok_lengths, seq_lengths = (
                    fg_native.seq_split_hash_arrow(
                        filled, delim, sep, int(c.hash_bucket_size)))
                return SequenceSparseData(self.name, vals, tok_lengths,
                                          seq_lengths)
        nulls = feat.is_null().to_numpy(zero_copy_only=False)
        steps = pc.split_pattern(feat.fill_null(""), delim)
        toks = pc.split_pattern(steps.values, sep)
        seq_offs = steps.offsets.to_numpy()
        # null rows are empty sequences, not one hashed "" step
        seq_lengths = np.where(nulls, 0, seq_offs[1:] - seq_offs[:-1]
                               ).astype(np.int32)
        tok_offs = toks.offsets.to_numpy()
        tok_lengths = (tok_offs[1:] - tok_offs[:-1]).astype(np.int32)
        keep_steps = np.repeat(~nulls, seq_offs[1:] - seq_offs[:-1])
        tok_lengths = tok_lengths[keep_steps]
        keep_tokens = np.repeat(keep_steps, tok_offs[1:] - tok_offs[:-1])
        tokens = np.asarray(
            [t for t, kp in zip(toks.values.to_pylist(), keep_tokens) if kp],
            dtype=object)
        ids = (self._vocab_to_ids(tokens) if len(tokens)
               else np.zeros((0,), np.int64))
        return SequenceSparseData(self.name, ids, tok_lengths, seq_lengths)
