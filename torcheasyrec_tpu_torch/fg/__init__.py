"""The native feature-generation library and its ctypes wrappers.

Counterpart of torcheasyrec_tpu/fg/__init__.py. ``csrc/fg_ops.cc`` is
compiled on first use with ``g++ -O3 -shared -fPIC -std=c++17 -pthread``
into ``torcheasyrec_tpu_torch/build/libfg_ops-<source hash>.so``: the
compiler writes a name of its own process's, which is then renamed into
place (``os.replace``), so processes that build at once never load a
half-written library. A build or load that fails raises; there is no
fallback. FG is host code in both packages: it turns raw columns into
ids and values before a batch reaches the card.

Beside each wrapper is its plain version (``np_hash_strings_mod``,
``np_hash_ints_mod``, ``np_bucketize``, ``np_split_hash``,
``np_seq_split_hash``), the same function in Python and numpy, which
the tests hold the library against. Where a wrapper cannot take an input
(a column that is not a string column, a separator longer than one
character, nulls in a sequence column), ``split_hash_ok`` and
``seq_split_hash_ok`` say so up front, and the features parse that
input in Python.
"""

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np
import pyarrow as pa

CSRC = Path(__file__).resolve().parent / "csrc" / "fg_ops.cc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build"
CXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17", "-pthread"]

_LIB: Optional[ctypes.CDLL] = None
_LOCK = threading.Lock()

_I32 = ctypes.POINTER(ctypes.c_int32)
_I64 = ctypes.POINTER(ctypes.c_int64)
_F64 = ctypes.POINTER(ctypes.c_double)


def library_path() -> Path:
    """``build/libfg_ops-<hash of the source and flags>.so``."""
    digest = hashlib.sha256(
        CSRC.read_bytes() + " ".join(CXX_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"libfg_ops-{digest[:16]}.so"


def build(cxx: Optional[str] = None) -> Path:
    """Compile the library unless it is built; returns its path. ``cxx``
    (else ``$CXX``, else ``g++``) is the compiler. Raises where the
    compiler fails."""
    target = library_path()
    if target.exists():
        return target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [cxx or os.environ.get("CXX") or "g++", *CXX_FLAGS, str(CSRC),
           "-o", str(tmp)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building {target.name} failed ({' '.join(cmd)},"
                           f" exit {proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, target)
    return target


def load() -> ctypes.CDLL:
    """The library, built and loaded on first use (raises where it cannot
    be)."""
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        lib = ctypes.CDLL(str(build()))
        lib.fg_hash64_strings_mod.argtypes = [
            _I32, ctypes.c_char_p, ctypes.c_int64, ctypes.c_uint64, _I64,
            ctypes.c_int]
        lib.fg_hash64_ints_mod.argtypes = [
            _I64, ctypes.c_int64, ctypes.c_uint64, _I64, ctypes.c_int]
        lib.fg_bucketize.argtypes = [
            _F64, ctypes.c_int64, _F64, ctypes.c_int64, _I64, ctypes.c_int]
        lib.fg_split_hash.argtypes = [
            _I32, ctypes.c_char_p, ctypes.c_int64, ctypes.c_char,
            ctypes.c_uint64, _I64, ctypes.c_int64, _I32]
        lib.fg_split_hash.restype = ctypes.c_int64
        lib.fg_seq_split_hash.argtypes = [
            _I32, ctypes.c_char_p, ctypes.c_int64, ctypes.c_char,
            ctypes.c_char, ctypes.c_uint64, _I64, ctypes.c_int64, _I32,
            ctypes.c_int64, _I32]
        lib.fg_seq_split_hash.restype = ctypes.c_int64
        _LIB = lib
        return lib


def _ptr(a: np.ndarray, kind):
    return a.ctypes.data_as(kind)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

_FNV64_OFFSET = 0xCBF29CE484222325
_FNV64_PRIME = 0x100000001B3


def fnv1a64(data: bytes) -> int:
    h = _FNV64_OFFSET
    for b in data:
        h = ((h ^ b) * _FNV64_PRIME) & 0xFFFFFFFFFFFFFFFF
    return h


def np_hash_strings_mod(tokens, num_buckets: int) -> np.ndarray:
    """FNV-1a of each token's UTF-8 bytes (``str(t)``) mod
    ``num_buckets``."""
    return np.asarray([fnv1a64(str(t).encode("utf-8")) % num_buckets
                       for t in tokens], np.int64).reshape(-1)


def np_hash_ints_mod(values, num_buckets: int) -> np.ndarray:
    """FNV-1a of each integer's decimal string mod ``num_buckets``."""
    return np_hash_strings_mod([str(int(v)) for v in values], num_buckets)


def np_bucketize(values, boundaries) -> np.ndarray:
    return np.searchsorted(np.asarray(boundaries, np.float64),
                           np.asarray(values, np.float64),
                           side="right").astype(np.int64)


def np_split_hash(str_array, sep: str, num_buckets: int
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """``split_hash_arrow`` in Python: a null or empty row has no token,
    empty tokens are dropped."""
    vals, lengths = [], []
    for s in combined(str_array).to_pylist():
        toks = [t for t in (s or "").split(sep) if t]
        vals += toks
        lengths.append(len(toks))
    return (np_hash_strings_mod(vals, num_buckets),
            np.asarray(lengths, np.int32))


def np_seq_split_hash(str_array, seq_delim: str, sep: str, num_buckets: int
                      ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """``seq_split_hash_arrow`` in Python: an empty row has no step, a
    step's empty tokens are dropped, and a step with no token hashes
    "" once."""
    vals, tok_lengths, seq_lengths = [], [], []
    for s in combined(str_array).to_pylist():
        steps = s.split(seq_delim) if s else []
        for step in steps:
            toks = [t for t in step.split(sep) if t] or [""]
            vals += toks
            tok_lengths.append(len(toks))
        seq_lengths.append(len(steps))
    return (np_hash_strings_mod(vals, num_buckets),
            np.asarray(tok_lengths, np.int32),
            np.asarray(seq_lengths, np.int32))


# ---------------------------------------------------------------------------
# wrappers of the library
# ---------------------------------------------------------------------------


def hash_strings_mod(tokens, num_buckets: int, threads: int = 4
                     ) -> np.ndarray:
    """FNV-1a hash of each token (``str(t)``'s UTF-8 bytes) modulo
    ``num_buckets`` -> int64 [n]."""
    encoded = [str(t).encode("utf-8") for t in tokens]
    n = len(encoded)
    out = np.empty(n, np.int64)
    if n == 0:
        return out
    offsets = np.zeros(n + 1, np.int32)
    np.cumsum([len(e) for e in encoded], out=offsets[1:])
    load().fg_hash64_strings_mod(
        _ptr(offsets, _I32), b"".join(encoded), n, num_buckets,
        _ptr(out, _I64), threads)
    return out


def hash_ints_mod(values, num_buckets: int, threads: int = 4) -> np.ndarray:
    """FNV-1a hash of each integer's decimal string modulo
    ``num_buckets`` -> int64 [n] (the bytes of ``hash_strings_mod(str(v))``)."""
    values = np.ascontiguousarray(values, np.int64)
    out = np.empty(len(values), np.int64)
    if len(values):
        load().fg_hash64_ints_mod(_ptr(values, _I64), len(values),
                                  num_buckets, _ptr(out, _I64), threads)
    return out


def bucketize(values, boundaries, threads: int = 4) -> np.ndarray:
    """``searchsorted(boundaries, values, side="right")`` -> int64 [n]."""
    values = np.ascontiguousarray(values, np.float64).reshape(-1)
    boundaries = np.ascontiguousarray(boundaries, np.float64)
    out = np.empty(len(values), np.int64)
    if len(values):
        load().fg_bucketize(_ptr(values, _F64), len(values),
                            _ptr(boundaries, _F64), len(boundaries),
                            _ptr(out, _I64), threads)
    return out


def combined(arr):
    """One Arrow array of a chunked one."""
    return arr.combine_chunks() if isinstance(arr, pa.ChunkedArray) else arr


def string_buffers(arr) -> Tuple[np.ndarray, bytes]:
    """A string array's (offsets int32 [n + 1], data bytes), the offsets
    absolute into ``data``."""
    arr = combined(arr)
    bufs = arr.buffers()
    n = len(arr)
    if bufs[1] is None:
        return np.zeros(n + 1, np.int32), b""
    off = np.frombuffer(bufs[1], dtype=np.int32,
                        count=n + 1 + arr.offset)[arr.offset:]
    data = bytes(bufs[2]) if bufs[2] is not None else b""
    return np.ascontiguousarray(off), data


def split_hash_ok(str_array, sep: str) -> bool:
    """Whether ``split_hash_arrow`` takes this column and separator."""
    return len(sep) == 1 and pa.types.is_string(combined(str_array).type)


def split_hash_arrow(str_array, sep: str, num_buckets: int
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """Split a string array on ``sep`` and FNV-hash each non-empty token
    mod ``num_buckets`` in C++ -> (values int64 [n_tokens], lengths
    int32 [n]); a null row has no token. Needs ``split_hash_ok``."""
    if not split_hash_ok(str_array, sep):
        raise ValueError(f"split_hash_arrow takes a string column and a "
                         f"one-character separator, not {sep!r}")
    arr = combined(str_array)
    offsets, data = string_buffers(arr)
    n = len(arr)
    cap = max(int(offsets[-1] - offsets[0]), 1)
    vals = np.empty(cap, np.int64)
    lengths = np.zeros(n, np.int32)
    total = load().fg_split_hash(
        _ptr(offsets, _I32), data, n, sep.encode("latin-1"), num_buckets,
        _ptr(vals, _I64), cap, _ptr(lengths, _I32))
    vals = vals[:total]
    if arr.null_count:
        # a null row's bytes (if any) are not its tokens
        nulls = np.asarray(arr.is_null())
        keep = np.repeat(~nulls, lengths)
        vals = vals[keep]
        lengths = np.where(nulls, 0, lengths).astype(np.int32)
    return vals, lengths


def seq_split_hash_ok(str_array, seq_delim: str, sep: str) -> bool:
    """Whether ``seq_split_hash_arrow`` takes this column: a string column
    without nulls and one-character delimiters."""
    arr = combined(str_array)
    return (len(seq_delim) == 1 and len(sep) == 1
            and pa.types.is_string(arr.type) and arr.null_count == 0)


def seq_split_hash_arrow(str_array, seq_delim: str, sep: str,
                         num_buckets: int
                         ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Two-level split (steps on ``seq_delim``, tokens on ``sep``) and the
    FNV hash of each token mod ``num_buckets``, in C++ -> (values int64
    [n_tokens], tokens per step int32 [n_steps], steps per row int32
    [n]). An empty row has no step; a step without a token hashes ""
    once. Needs ``seq_split_hash_ok``."""
    if not seq_split_hash_ok(str_array, seq_delim, sep):
        raise ValueError("seq_split_hash_arrow takes a string column "
                         "without nulls and one-character delimiters")
    arr = combined(str_array)
    offsets, data = string_buffers(arr)
    n = len(arr)
    nbytes = int(offsets[-1] - offsets[0])
    # a row of b bytes has at most b + 1 steps, and a step of s bytes at
    # most max(s, 1) tokens: these capacities never overflow
    max_steps = nbytes + n + 1
    max_tokens = 2 * nbytes + n + 1
    vals = np.empty(max_tokens, np.int64)
    tok_lengths = np.zeros(max_steps, np.int32)
    seq_lengths = np.zeros(n, np.int32)
    total = load().fg_seq_split_hash(
        _ptr(offsets, _I32), data, n, seq_delim.encode("latin-1"),
        sep.encode("latin-1"), num_buckets, _ptr(vals, _I64), max_tokens,
        _ptr(tok_lengths, _I32), max_steps, _ptr(seq_lengths, _I32))
    if total < 0:
        raise RuntimeError(f"fg_seq_split_hash overflowed ({total})")
    return (vals[:total], tok_lengths[:int(seq_lengths.sum())],
            seq_lengths)
