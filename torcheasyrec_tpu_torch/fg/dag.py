"""The native FG DAG: a batch's feature generation in one C++ call.

Counterpart of torcheasyrec_tpu/fg/dag.py. Each eligible FG feature
becomes one ``FgTask`` in a task array that the library's worker pool
(``fg_run_dag`` in ``csrc/fg_ops.cc``, ``fg_threads`` workers) drains, so
a wide model's id, raw, combo, lookup, match, overlap and kv-dot
transforms run concurrently outside the interpreter lock. The other
features (vocab-mapped sequences, weighted ids, expr, tokenize, ...)
keep their Python parse. A value task (raw, lookup, match, overlap,
kv-dot) writes float32 values; the normalizer and the boundaries are
then applied in numpy as in the Python parse, so that the DAG's batch
equals the Python parses' bit for bit (the C++ of the JAX package
normalizes and bucketizes the double, which moves ids at boundaries and
values by an ulp).

Eligibility is decided by rule: per feature from its config when the
DAG is built (``eligible``), and per batch from the input columns
(``_columns_ok``: column types the task reads, nulls a vocab task cannot
represent). A task whose C++ status is not 0 (too long a combo key, more
than 256 distinct tokens, a kv value whose float parse could differ from
Python's) is handed back: that feature is parsed in Python for the
batch, and ``handbacks[name]`` counts it.
"""

import ctypes
from typing import Any, Dict, List

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc

from torcheasyrec_tpu_torch import fg as fg_native
from torcheasyrec_tpu_torch.features.feature import (
    FG_NONE,
    DenseData,
    SparseData,
    parse_normalizer,
)

KIND_ID_HASH = 0
KIND_COMBO_HASH = 1
KIND_RAW = 2
KIND_KV_LOOKUP = 3
KIND_MATCH_LOOKUP = 4
KIND_OVERLAP = 5
KIND_KV_DOT = 6
KIND_ID_VOCAB = 7
OVERLAP_METHODS = ("query_common_ratio", "title_common_ratio",
                   "is_contain", "is_equal")


class FgTask(ctypes.Structure):
    # the layout of FgTask in csrc/fg_ops.cc
    _fields_ = [
        ("offsets", ctypes.c_void_p * 4),
        ("data", ctypes.c_void_p * 4),
        ("fvals", ctypes.c_void_p),
        ("boundaries", ctypes.c_void_p),
        ("out_vals", ctypes.c_void_p),
        ("out_fvals", ctypes.c_void_p),
        ("out_lengths", ctypes.c_void_p),
        ("n_rows", ctypes.c_int64),
        ("n_bounds", ctypes.c_int64),
        ("max_tokens", ctypes.c_int64),
        ("out_total", ctypes.c_int64),
        ("num_buckets", ctypes.c_uint64),
        ("norm_threshold", ctypes.c_double),
        ("norm_default", ctypes.c_double),
        ("default_fval", ctypes.c_double),
        ("kind", ctypes.c_int32),
        ("n_inputs", ctypes.c_int32),
        ("normalizer", ctypes.c_int32),
        ("status", ctypes.c_int32),
        ("sep", ctypes.c_int32),
        ("_pad", ctypes.c_int32),
        ("aux_vals", ctypes.c_void_p),
        ("n_aux", ctypes.c_int64),
        ("oov_val", ctypes.c_int64),
    ]


def _sep(c) -> str:
    return getattr(c, "separator", "\x1d") or "\x1d"


def eligible(f: Any) -> bool:
    """Whether the DAG runs feature ``f`` (from its config alone)."""
    c = f.config
    tname = type(f).__name__
    if f.is_sequence:
        return False
    if tname == "IdFeature":
        if f.is_weighted or f.is_zch:
            return False
        if int(getattr(c, "hash_bucket_size", 0)) > 0:
            return len(_sep(c)) == 1
        # a vocab: the whole cell is one token, looked up by bsearch
        return f.vocab_table_and_oov() is not None
    if tname == "ComboFeature":
        return (int(getattr(c, "hash_bucket_size", 0)) > 0
                and 2 <= len(f.side_inputs) <= 4)
    if tname == "RawFeature":
        return max(f.value_dim, 1) == 1 and f.dense_emb_kind is None
    if tname == "LookupFeature":
        # dense single-value lookups (the id-mapped kinds stay in Python)
        return (not f.is_sparse and max(f.value_dim, 1) <= 1
                and len(f.side_inputs) >= 2 and len(_sep(c)) == 1)
    if tname == "MatchFeature":
        return (not f.is_sparse and max(f.value_dim, 1) <= 1
                and len(f.side_inputs) >= 3)
    if tname == "OverlapFeature":
        return (getattr(c, "method", "") in OVERLAP_METHODS
                and len(f.side_inputs) >= 2 and len(_sep(c)) == 1)
    if tname == "KvDotProduct":
        return len(f.side_inputs) >= 2 and len(_sep(c)) == 1
    return False


# column types a task reads: strings are read as they are, the others
# cast to strings first (a numeric raw feature reads its values)
def _castable(t: pa.DataType) -> bool:
    return (pa.types.is_string(t) or pa.types.is_large_string(t)
            or pa.types.is_integer(t) or pa.types.is_floating(t)
            or pa.types.is_boolean(t) or pa.types.is_null(t))


def _prep_string_col(arr, default: str = "") -> pa.Array:
    """The column as strings; a null (or, with a default, an empty cell)
    becomes ``default``."""
    arr = fg_native.combined(arr)
    if not pa.types.is_string(arr.type):
        arr = arr.cast(pa.string(), safe=False)
    if default:
        empty = pc.equal(arr, pa.scalar(""))
        arr = pc.if_else(empty, pa.nulls(len(arr), pa.string()), arr)
        return arr.fill_null(default)
    return arr.fill_null("")


class FgDag:
    """The FG features of a model, split into DAG tasks and Python parses;
    ``parse`` runs one ``fg_run_dag`` call a batch. Building it loads the
    library (raises where it cannot be built)."""

    def __init__(self, features: List[Any], threads: int = 1) -> None:
        self._threads = max(int(threads), 1)
        self.native = [f for f in features
                       if f._fg_mode != FG_NONE and eligible(f)]
        self._vocab_blobs: Dict[str, tuple] = {}
        # {feature: batches whose task the C++ handed back}
        self.handbacks: Dict[str, int] = {}
        # {feature: batches whose columns the tasks do not take}
        self.routed: Dict[str, int] = {}
        if self.native:
            lib = fg_native.load()
            lib.fg_run_dag.argtypes = [ctypes.POINTER(FgTask),
                                       ctypes.c_int64, ctypes.c_int]
            lib.fg_run_dag.restype = ctypes.c_int
            self._lib = lib

    def _columns_ok(self, f: Any, input_data: Dict[str, Any]) -> bool:
        """Whether this batch's columns fit ``f``'s task."""
        for col in self._columns(f):
            arr = input_data[col]
            if not _castable(arr.type):
                return False
        if type(f).__name__ == "IdFeature" and not int(
                getattr(f.config, "hash_bucket_size", 0)):
            # the Python vocab path drops a null row (length 0) where a
            # task can only write an id: nulls need a default_value
            raw = input_data[self._columns(f)[0]]
            if raw.null_count and not str(
                    getattr(f.config, "default_value", "") or ""):
                return False
        return True

    @staticmethod
    def _columns(f: Any) -> List[str]:
        return [col for _, col in f.side_inputs] or [f.name]

    def parse(self, input_data: Dict[str, Any], is_training: bool = False
              ) -> Dict[str, Any]:
        """{feature name: parsed data} of every DAG feature: one
        ``fg_run_dag`` call over the tasks, then the Python parse of the
        features whose columns the tasks do not take or whose task was
        handed back."""
        run, python = [], []
        for f in self.native:
            if self._columns_ok(f, input_data):
                run.append(f)
            else:
                python.append(f)
                self.routed[f.name] = self.routed.get(f.name, 0) + 1
        out: Dict[str, Any] = {}
        tasks = (FgTask * max(len(run), 1))()
        keepalive: List[Any] = []
        built = [self._build_task(tasks[i], f, input_data, keepalive)
                 for i, f in enumerate(run)]
        if run:
            self._lib.fg_run_dag(tasks, len(run), self._threads)
        for i, f in enumerate(run):
            t = tasks[i]
            if t.status != 0:
                self.handbacks[f.name] = self.handbacks.get(f.name, 0) + 1
                python.append(f)
                continue
            kind, n, out_vals, out_fvals, out_lengths = built[i]
            if kind in (KIND_ID_HASH, KIND_COMBO_HASH, KIND_ID_VOCAB):
                out[f.name] = SparseData(f.name, out_vals[:t.out_total],
                                         out_lengths, None)
                continue
            vals = out_fvals.reshape(n, 1)
            if kind == KIND_RAW:
                norm = parse_normalizer(getattr(f.config, "normalizer", ""))
                vals = norm(vals) if norm else vals
            if f.is_sparse:
                ids = f._bucketize(vals[:, 0])
                out[f.name] = SparseData(f.name, ids,
                                         np.ones_like(ids, np.int32), None)
            else:
                out[f.name] = DenseData(f.name, vals.astype(np.float32))
        for f in python:
            out[f.name] = f.parse(input_data, is_training)
        return out

    def _set_string(self, t, j: int, arr: pa.Array, keepalive) -> None:
        off, data = fg_native.string_buffers(arr)
        keepalive += [off, data]
        t.offsets[j] = off.ctypes.data
        t.data[j] = ctypes.cast(ctypes.c_char_p(data),
                                ctypes.c_void_p).value or 0

    @staticmethod
    def _outputs(t, n: int, keepalive):
        """A float value per row. A value task never gets the normalizer
        or the boundaries: ``parse`` applies them in numpy to the float32
        values, as the Python parse does, so the two agree bit for bit
        (the C++ would normalize and bucketize the double)."""
        out_lengths = np.zeros(n, np.int32)
        out_fvals = np.empty(n, np.float32)
        keepalive += [out_lengths, out_fvals]
        t.out_lengths = out_lengths.ctypes.data
        t.out_fvals = out_fvals.ctypes.data
        return None, out_fvals, out_lengths

    def _build_task(self, t, f, input_data, keepalive):
        c = f.config
        tname = type(f).__name__
        cols = self._columns(f)
        if tname == "RawFeature":
            arr = fg_native.combined(input_data[cols[0]])
            n = len(arr)
            t.kind = KIND_RAW
            t.n_inputs = 1
            t.default_fval = float(getattr(c, "default_value", "0") or 0)
            if pa.types.is_floating(arr.type) or pa.types.is_integer(
                    arr.type):
                fv = np.ascontiguousarray(
                    arr.cast(pa.float64(), safe=False)
                    .fill_null(t.default_fval).to_numpy(zero_copy_only=False))
                keepalive.append(fv)
                t.fvals = fv.ctypes.data
            else:
                self._set_string(t, 0, _prep_string_col(arr), keepalive)
            t.n_rows = n
            return (KIND_RAW, n, *self._outputs(t, n, keepalive))

        default = (str(getattr(c, "default_value", "") or "")
                   if tname == "IdFeature" else "")
        str_cols = [_prep_string_col(input_data[col], default)
                    for col in cols]
        n = len(str_cols[0])
        for j, sc in enumerate(str_cols):
            self._set_string(t, j, sc, keepalive)
        t.n_rows = n
        t.n_inputs = len(str_cols)

        if tname == "IdFeature" and not int(getattr(c, "hash_bucket_size",
                                                    0)):
            off, data, vals, oov = self._vocab_blob(f)
            t.kind = KIND_ID_VOCAB
            t.offsets[1] = off.ctypes.data
            t.data[1] = ctypes.cast(ctypes.c_char_p(data),
                                    ctypes.c_void_p).value or 0
            t.aux_vals = vals.ctypes.data
            t.n_aux = len(vals)
            t.oov_val = oov
            return (KIND_ID_VOCAB, n,
                    *self._id_outputs(t, n, n, keepalive))
        if tname == "IdFeature":
            t.kind = KIND_ID_HASH
            t.num_buckets = int(c.hash_bucket_size)
            t.sep = ord(_sep(c)[0])
            off, _ = fg_native.string_buffers(str_cols[0])
            return (KIND_ID_HASH, n, *self._id_outputs(
                t, n, max(int(off[-1] - off[0]), 1), keepalive))
        if tname == "ComboFeature":
            t.kind = KIND_COMBO_HASH
            t.num_buckets = int(c.hash_bucket_size)
            return (KIND_COMBO_HASH, n,
                    *self._id_outputs(t, n, n, keepalive))
        if tname == "OverlapFeature":
            t.kind = KIND_OVERLAP
            t.sep = ord(_sep(c)[0])
            t.normalizer = OVERLAP_METHODS.index(c.method)
        elif tname == "KvDotProduct":
            t.kind = KIND_KV_DOT
            t.sep = ord(_sep(c)[0])
        elif tname == "MatchFeature":
            t.kind = KIND_MATCH_LOOKUP
            t.default_fval = 0.0  # a missing key reads 0, as in Python
        else:  # LookupFeature
            t.kind = KIND_KV_LOOKUP
            t.sep = ord(_sep(c)[0])
            t.default_fval = 0.0
        return (t.kind, n, *self._outputs(t, n, keepalive))

    def _id_outputs(self, t, n: int, cap: int, keepalive):
        out_vals = np.empty(cap, np.int64)
        out_lengths = np.zeros(n, np.int32)
        keepalive += [out_vals, out_lengths]
        t.out_vals = out_vals.ctypes.data
        t.out_lengths = out_lengths.ctypes.data
        t.max_tokens = cap
        return out_vals, None, out_lengths

    def _vocab_blob(self, f):
        """(sorted keys' offsets, their bytes, ids, oov id) of ``f``'s
        vocab, built once: keys sorted by UTF-8 bytes, which is Python's
        code-point order."""
        blob = self._vocab_blobs.get(f.name)
        if blob is None:
            table, oov = f.vocab_table_and_oov()
            table = {str(k): int(v) for k, v in table.items()}
            keys = sorted(table)
            enc = [k.encode("utf-8") for k in keys]
            off = np.zeros(len(enc) + 1, np.int32)
            np.cumsum([len(e) for e in enc], out=off[1:])
            vals = np.asarray([table[k] for k in keys], np.int64)
            blob = (off, b"".join(enc), vals, int(oov))
            self._vocab_blobs[f.name] = blob
        return blob
