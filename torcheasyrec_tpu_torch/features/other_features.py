"""The feature classes beyond id and raw features.

Counterpart of torcheasyrec_tpu/features/other_features.py: combo,
lookup, match, expr, overlap, tokenize, kv-dot-product, custom,
bool-mask and combine features. Each parses pre-encoded columns in
FG_NONE mode through the base class and generates the feature from its
input columns in FG_NORMAL mode (``_parse_fg``), with the JAX package's
results. ``CombineFeature`` is the exception: it combines the outputs of
the features its expressions name, so ``DataParser`` builds it
(``combine``) after those features' parses.
"""

import importlib
import pydoc
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc

from torcheasyrec_tpu_torch.features.feature import (
    FG_NONE,
    BaseFeature,
    DenseData,
    SparseData,
)


def _strings(input_data: Dict[str, Any], col: str) -> List[Optional[str]]:
    return input_data[col].cast(pa.string(), safe=False).to_pylist()


def _id_mapped(c) -> bool:
    return bool(len(c.boundaries) or c.hash_bucket_size or c.num_buckets
                or len(c.vocab_list) or len(c.vocab_dict))


class ComboFeature(BaseFeature):
    """The cross of its inputs: their values joined with "\\x1d" and
    mapped to one id (hashed, or through a vocab); a row with a null or
    empty input has no id."""

    @property
    def is_sparse(self) -> bool:
        return True

    def _parse_fg(self, input_data: Dict[str, pa.Array],
                  is_training: bool) -> Any:
        cols = []
        for _, col in self.side_inputs:
            arr = input_data[col]
            if isinstance(arr, pa.ChunkedArray):
                arr = arr.combine_chunks()
            cols.append(arr.cast(pa.string(), safe=False))
        valid = None
        for col in cols:
            v = pc.and_(pc.is_valid(col),
                        pc.not_equal(pc.fill_null(col, ""), ""))
            valid = v if valid is None else pc.and_(valid, v)
        joined = pc.binary_join_element_wise(
            *[pc.fill_null(col, "") for col in cols], "\x1d")
        lengths = np.ascontiguousarray(
            valid.to_numpy(zero_copy_only=False)).astype(np.int32)
        tokens = joined.filter(valid)
        ids = (self._vocab_to_ids(np.asarray(tokens.to_pylist(),
                                             dtype=object))
               if len(tokens) else np.zeros((0,), np.int64))
        return SparseData(self.name, ids, lengths)


def _value_output(feature: BaseFeature, out: np.ndarray,
                  tokens: List[str], n: int) -> Any:
    """A looked-up value as dense [B, 1], or as one id per row: bucketized
    by ``boundaries``, else the value's string mapped as a token."""
    if feature.is_sparse:
        if len(feature.config.boundaries):
            ids = feature._bucketize(out)
        else:
            ids = feature._vocab_to_ids(np.asarray(tokens, dtype=object))
        return SparseData(feature.name, ids, np.ones((n,), np.int32))
    return DenseData(feature.name, out[:, None])


class LookupFeature(BaseFeature):
    """The value of ``key`` in a "k:v<sep>k:v" map column; a missing key
    (or a cell that is no string) reads 0 and the token ""."""

    @property
    def expressions(self) -> List[str]:
        c = self.config
        if getattr(c, "map", "") or getattr(c, "key", ""):
            return [c.map, c.key]
        return super().expressions

    @property
    def is_sparse(self) -> bool:
        return _id_mapped(self.config)

    def _parse_fg(self, input_data: Dict[str, pa.Array],
                  is_training: bool) -> Any:
        (_, map_col), (_, key_col) = self.side_inputs[:2]
        maps = input_data[map_col].to_pylist()
        keys = _strings(input_data, key_col)
        sep = self.config.separator or "\x1d"
        n = len(keys)
        out = np.zeros((n,), np.float32)
        tokens = [""] * n
        for i in range(n):
            m, k = maps[i], keys[i]
            if m is None or k is None:
                continue
            if isinstance(m, str):
                v = dict(p.split(":", 1) for p in m.split(sep)
                         if ":" in p).get(k)
            elif isinstance(m, dict):
                v = m.get(k)
            else:
                v = None
            if v is not None:
                tokens[i] = str(v)
                out[i] = _float_or_zero(v)
        return _value_output(self, out, tokens, n)


def _float_or_zero(v) -> float:
    """``float(v)``, 0 where Python's float() does not read it."""
    try:
        return float(v)
    except ValueError:
        return 0.0


class MatchFeature(BaseFeature):
    """The value at (``pkey``, ``skey``) of a nested map column
    "pk^k:v,k:v|pk^...": the last group of a pk replaces the earlier
    ones; a missing key reads 0."""

    @property
    def expressions(self) -> List[str]:
        c = self.config
        if getattr(c, "nested_map", ""):
            return [c.nested_map, c.pkey, c.skey]
        return super().expressions

    @property
    def is_sparse(self) -> bool:
        return _id_mapped(self.config)

    def _parse_fg(self, input_data: Dict[str, pa.Array],
                  is_training: bool) -> Any:
        (_, nested_col), (_, pkey_col), (_, skey_col) = self.side_inputs[:3]
        nested = _strings(input_data, nested_col)
        pkeys = _strings(input_data, pkey_col)
        skeys = _strings(input_data, skey_col)
        n = len(nested)
        out = np.zeros((n,), np.float32)
        tokens = [""] * n
        for i in range(n):
            if nested[i] is None:
                continue
            table = {}
            for grp in nested[i].split("|"):
                if "^" not in grp:
                    continue
                pk, kvs = grp.split("^", 1)
                table[pk] = dict(p.split(":", 1) for p in kvs.split(",")
                                 if ":" in p)
            v = table.get(pkeys[i], {}).get(skeys[i])
            if v is not None:
                tokens[i] = str(v)
                out[i] = _float_or_zero(v)
        return _value_output(self, out, tokens, n)


# the names an ExprFeature's expression may use besides its variables
_EXPR_NAMESPACE = {
    "np": np, "log": np.log, "exp": np.exp, "sqrt": np.sqrt, "abs": np.abs,
    "min": np.minimum, "max": np.maximum,
    "sigmoid": lambda x: 1.0 / (1.0 + np.exp(-x)),
}


class ExprFeature(BaseFeature):
    """An arithmetic ``expression`` over its ``variables`` (input
    columns read as float64, nulls 0), evaluated with numpy and the
    names of ``_EXPR_NAMESPACE`` only (no builtins)."""

    @property
    def is_sparse(self) -> bool:
        return len(self.config.boundaries) > 0

    @property
    def expressions(self) -> List[str]:
        return list(self.config.variables)

    def _parse_fg(self, input_data: Dict[str, pa.Array],
                  is_training: bool) -> Any:
        local: Dict[str, np.ndarray] = {}
        for _, col in self.side_inputs:
            arr = input_data[col].cast(pa.float64(), safe=False)
            local[col] = np.nan_to_num(
                arr.to_numpy(zero_copy_only=False).astype(np.float64))
        out = eval(self.config.expression,  # noqa: S307
                   {"__builtins__": {}}, {**_EXPR_NAMESPACE, **local})
        out = np.asarray(out, dtype=np.float32)
        n = len(next(iter(local.values())))
        if out.ndim == 0:
            out = np.full((n,), float(out), np.float32)
        if self.is_sparse:
            return SparseData(self.name, self._bucketize(out),
                              np.ones((n,), np.int32))
        return DenseData(self.name, out[:, None])


class OverlapFeature(BaseFeature):
    """Token-set overlap of a query and a title column (``method``:
    query_common_ratio, title_common_ratio, is_contain, is_equal)."""

    @property
    def is_sparse(self) -> bool:
        return len(self.config.boundaries) > 0

    def _parse_fg(self, input_data: Dict[str, pa.Array],
                  is_training: bool) -> Any:
        (_, qcol), (_, tcol) = self.side_inputs[:2]
        sep = self.config.separator or "\x1d"
        qs = _strings(input_data, qcol)
        ts = _strings(input_data, tcol)
        method = self.config.method
        n = len(qs)
        out = np.zeros((n,), np.float32)
        for i in range(n):
            qset = set((qs[i] or "").split(sep)) - {""}
            tset = set((ts[i] or "").split(sep)) - {""}
            if method == "query_common_ratio":
                out[i] = len(qset & tset) / max(len(qset), 1)
            elif method == "title_common_ratio":
                out[i] = len(qset & tset) / max(len(tset), 1)
            elif method == "is_contain":
                out[i] = float(bool(qset) and qset <= tset)
            elif method == "is_equal":
                out[i] = float(qset == tset and bool(qset))
        if self.is_sparse:
            return SparseData(self.name, self._bucketize(out),
                              np.ones((n,), np.int32))
        return DenseData(self.name, out[:, None])


class TokenizeFeature(BaseFeature):
    """Text tokenized into ids by the ``vocab_file`` tokenizer: a
    SentencePiece ``.model`` (``tokenizer_type: "sentencepiece"``, read
    by ``features/spiece.py``) or a BPE ``tokenizer.json`` (needs the
    ``tokenizers`` package). A tokenizer that does not load raises. The
    ``text_normalizer`` (case, full-width to half-width, stop characters)
    runs first."""

    @property
    def is_sparse(self) -> bool:
        return True

    @property
    def num_embeddings(self) -> int:
        if self.config.vocab_file:
            return self._get_tokenizer().get_vocab_size()
        return super().num_embeddings

    def _get_tokenizer(self):
        tok = getattr(self, "_tokenizer", None)
        if tok is not None:
            return tok
        path = self.config.vocab_file
        ttype = (getattr(self.config, "tokenizer_type", "") or "bpe").lower()
        if ttype == "sentencepiece" or path.endswith(".model"):
            from torcheasyrec_tpu_torch.features.spiece import (
                SpmTokenizerAdapter,
            )

            tok = SpmTokenizerAdapter.from_file(path)
        else:
            try:
                from tokenizers import Tokenizer
            except ImportError as e:
                raise ImportError(
                    f"{self.name}: the BPE tokenizer {path} needs the "
                    f"'tokenizers' package, which is not installed") from e
            tok = Tokenizer.from_file(path)
        self._tokenizer = tok
        return tok

    def _normalize(self, text: str) -> str:
        """The text normalizer: a text past ``max_length`` passes as it
        is; the options (by default LOWER2UPPER, SBC2DBC, CHT2CHS and
        FILTER, as in TorchEasyRec) turn full-width characters half-width
        (SBC2DBC), fold the case (UPPER2LOWER, else LOWER2UPPER) and drop
        the stop characters (FILTER). CHT2CHS needs a conversion table:
        it is skipped with a warning."""
        c = self.config
        if not c.HasField("text_normalizer"):
            return text
        nc = c.text_normalizer
        if nc.max_length and len(text) > nc.max_length:
            return text
        opts = set(nc.norm_options) or {0, 2, 3, 4}
        if 3 in opts and not getattr(self, "_warned_cht", False):
            import logging

            logging.getLogger("tzrec_tpu_torch").warning(
                f"{self.name}: CHT2CHS needs a conversion table; skipped")
            self._warned_cht = True
        if 2 in opts:
            text = "".join(
                chr(o - 0xFEE0) if 0xFF01 <= (o := ord(ch)) <= 0xFF5E
                else (" " if o == 0x3000 else ch)
                for ch in text)
        if 1 in opts:
            text = text.lower()
        elif 0 in opts:
            text = text.upper()
        if 4 in opts:
            stops = self._stop_chars()
            if stops:
                text = "".join(ch for ch in text if ch not in stops)
        return text

    def _stop_chars(self) -> set:
        stops = getattr(self, "_stop_set", None)
        if stops is None:
            stops = set()
            path = self.config.text_normalizer.stop_char_file
            if path:
                with open(path, encoding="utf-8") as fh:
                    stops = {line.rstrip("\n") for line in fh
                             if line.rstrip("\n")}
            self._stop_set = stops
        return stops

    def _parse_fg(self, input_data: Dict[str, pa.Array],
                  is_training: bool) -> Any:
        texts = self._input_column(input_data).cast(
            pa.string(), safe=False).to_pylist()
        tok = self._get_tokenizer()
        values: List[int] = []
        lengths = np.zeros((len(texts),), np.int32)
        for i, t in enumerate(texts):
            if not t:
                continue
            ids = tok.encode(self._normalize(t)).ids
            values.extend(ids)
            lengths[i] = len(ids)
        return SparseData(self.name, np.asarray(values, np.int64), lengths)


class KvDotProduct(BaseFeature):
    """The dot product of two "k:v<sep>k:v" columns over their common
    keys (a later duplicate key wins; a pair without a value Python's
    float() reads is skipped)."""

    @property
    def is_sparse(self) -> bool:
        return len(self.config.boundaries) > 0

    def _parse_fg(self, input_data: Dict[str, pa.Array],
                  is_training: bool) -> Any:
        (_, c1), (_, c2) = self.side_inputs[:2]
        sep = self.config.separator or "\x1d"
        a1 = _strings(input_data, c1)
        a2 = _strings(input_data, c2)
        n = len(a1)
        out = np.zeros((n,), np.float32)

        def kv(s):
            pairs = {}
            for p in (s or "").split(sep):
                k, _, v = p.partition(":")
                if v:
                    try:
                        pairs[k] = float(v)
                    except ValueError:
                        pass
            return pairs

        for i in range(n):
            kv1, kv2 = kv(a1[i]), kv(a2[i])
            out[i] = sum(kv1[k] * kv2[k] for k in kv1.keys() & kv2.keys())
        if self.is_sparse:
            return SparseData(self.name, self._bucketize(out),
                              np.ones((n,), np.int32))
        return DenseData(self.name, out[:, None])


_CUSTOM_OP_REGISTRY: Dict[str, Callable] = {}


def register_custom_op(name: str, fn: Callable) -> None:
    """Register a custom-feature op under ``name``: ``fn(columns, params)``
    returns (values, lengths) for a sparse feature or a [B, D] (or [B])
    array for a dense one; ``columns`` maps the feature's input columns
    to their Arrow arrays, ``params`` is ``operator_params`` as a dict."""
    _CUSTOM_OP_REGISTRY[name] = fn


def load_by_path(path: str) -> Any:
    """A function by dotted path (``package.module.fn``)."""
    obj = pydoc.locate(path.strip())
    if obj is None:
        module_path, _, attr = path.strip().rpartition(".")
        if module_path:
            obj = getattr(importlib.import_module(module_path), attr, None)
    if obj is None:
        raise ValueError(f"cannot load the custom op {path!r}: register it "
                         f"with register_custom_op or give a dotted path")
    return obj


class CustomFeature(BaseFeature):
    """A user op's feature: ``operator_name`` names an op registered with
    ``register_custom_op``, else a function by dotted path."""

    @property
    def is_sparse(self) -> bool:
        return not bool(getattr(self.config, "is_dense", False))

    def _op(self) -> Callable:
        name = self.config.operator_name
        op = _CUSTOM_OP_REGISTRY.get(name)
        return op if op is not None else load_by_path(name)

    def _parse_fg(self, input_data: Dict[str, pa.Array],
                  is_training: bool) -> Any:
        params = {}
        if self.config.HasField("operator_params"):
            from google.protobuf import json_format

            params = json_format.MessageToDict(self.config.operator_params)
        cols = {c: input_data[c] for _, c in self.side_inputs
                if c in input_data}
        out = self._op()(cols, params)
        if self.is_sparse:
            values, lengths = out
            return SparseData(self.name, np.asarray(values, np.int64),
                              np.asarray(lengths, np.int32))
        arr = np.asarray(out, np.float32)
        return DenseData(self.name, arr[:, None] if arr.ndim == 1 else arr)


class BoolMaskFeature(BaseFeature):
    """The ids of a value list kept where the mask list (same separator)
    holds "1", "true" or "True"."""

    @property
    def is_sparse(self) -> bool:
        return True

    def _parse_fg(self, input_data: Dict[str, pa.Array],
                  is_training: bool) -> Any:
        (_, vcol), (_, mcol) = self.side_inputs[:2]
        sep = self.config.separator or "\x1d"
        vals = _strings(input_data, vcol)
        masks = _strings(input_data, mcol)
        n = len(vals)
        tokens: List[str] = []
        lengths = np.zeros((n,), np.int32)
        for i in range(n):
            kept = [v for v, m in zip((vals[i] or "").split(sep),
                                      (masks[i] or "").split(sep))
                    if v and m in ("1", "true", "True")]
            tokens.extend(kept)
            lengths[i] = len(kept)
        ids = (self._vocab_to_ids(np.asarray(tokens, dtype=object))
               if tokens else np.zeros((0,), np.int64))
        return SparseData(self.name, ids, lengths)


class CombineFeature(BaseFeature):
    """The outputs of the features its expressions name (``feature:<name>``
    or ``<name>``), combined. FG_NONE reads its own encoded column. In
    FG_NORMAL mode ``DataParser`` calls ``combine`` with the upstream
    parses: a sparse combine feature concatenates the upstream values
    per row (ids as their decimal strings, dense values bucketized by
    ``boundaries`` or as their strings) and maps them as tokens; a dense
    one combines the upstream values by ``combiner`` (concat along the
    width, or sum, mean, max, min elementwise)."""

    @property
    def is_sparse(self) -> bool:
        return _id_mapped(self.config)

    @property
    def inputs(self) -> List[str]:
        """Its own encoded column in FG_NONE mode; no column otherwise
        (it reads its upstream features' parses)."""
        return [self.name] if self._fg_mode == FG_NONE else []

    @property
    def upstream(self) -> List[str]:
        """The names of the combined features."""
        return [col for _, col in self.side_inputs]

    def _parse_fg(self, input_data: Dict[str, pa.Array],
                  is_training: bool) -> Any:
        raise RuntimeError(
            f"{self.name}: a combine feature is built from its upstream "
            f"features' parses (DataParser.parse calls combine)")

    def combine(self, parsed: Dict[str, Any]) -> Any:
        ups = [parsed[name] for name in self.upstream]
        # an upstream of one row (a user-side feature under INPUT_TILE)
        # stands for every row
        n = max(_num_rows(up) for up in ups)
        if self.is_sparse:
            rows = [[] for _ in range(n)]
            for up in ups:
                rows_up = _rows_of(self, up)
                if len(rows_up) == 1:
                    rows_up = rows_up * n
                rows = [a + b for a, b in zip(rows, rows_up)]
            lengths = np.asarray([len(r) for r in rows], np.int32)
            tokens = [t for r in rows for t in r]
            ids = (self._vocab_to_ids(np.asarray(tokens, dtype=object))
                   if tokens else np.zeros((0,), np.int64))
            return SparseData(self.name, ids, lengths)
        vals = [np.broadcast_to(np.asarray(up.values, np.float32),
                                (n, up.values.shape[1])) for up in ups]
        how = (self.config.combiner or "concat").lower()
        if how == "concat":
            out = np.concatenate(vals, axis=1)
        else:
            fn = {"sum": np.sum, "mean": np.mean, "max": np.max,
                  "min": np.min}[how]
            out = fn(np.stack(vals), axis=0)
        return DenseData(self.name, out.astype(np.float32))


def _num_rows(data: Any) -> int:
    return len(data.lengths) if isinstance(data, SparseData) else len(
        data.values)


def _rows_of(feature: CombineFeature, data: Any) -> List[List[str]]:
    """An upstream parse's tokens per row: sparse ids as decimal strings,
    dense values bucketized (``boundaries``) or as strings."""
    if isinstance(data, SparseData):
        starts = np.concatenate([[0], np.cumsum(data.lengths)])
        vals = [str(int(v)) for v in data.values]
        return [vals[starts[i]:starts[i + 1]]
                for i in range(len(data.lengths))]
    v = np.asarray(data.values, np.float32)
    if len(feature.config.boundaries):
        b = feature._bucketize(v.reshape(-1)).reshape(v.shape)
        return [[str(int(x)) for x in row] for row in b]
    return [[repr(float(x)) for x in row] for row in v]
