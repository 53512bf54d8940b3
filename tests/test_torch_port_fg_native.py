"""The port's native FG library (``torcheasyrec_tpu_torch/fg``) against the
JAX package's wrappers and against its own plain versions: the FNV-1a
hash of strings and of integers, the bucketizer, the split-hash and the
sequence split-hash, with "", non-ASCII text, nulls and 300-byte
tokens; and the build: concurrent builds load, a failed one raises."""

import os
import subprocess
import sys

import numpy as np
import pyarrow as pa
import pytest

from torch_port_helpers import ready_jax_fg_native
from torcheasyrec_tpu import fg as jax_fg
from torcheasyrec_tpu_torch import fg


@pytest.fixture(autouse=True, scope="module")
def _jax_fg_native():
    """The JAX package's FG natives, loaded whole before any test here
    (``torch_port_helpers.ready_jax_fg_native``)."""
    ready_jax_fg_native()


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOKENS = ["beijing", "shanghai", "", "新疆", "x" * 300, "123", "é中文 ",
          "\x1d", "a;b"]
NUM_BUCKETS = [1, 7, 100_003, 1 << 40]


def _rand_tokens(n, seed):
    rng = np.random.default_rng(seed)
    alphabet = ["a", "b", "z", "0", "9", "é", "中", " ", "-"]
    return ["".join(rng.choice(alphabet, k)) for k in rng.integers(0, 12, n)]


@pytest.mark.parametrize("nb", NUM_BUCKETS)
def test_hash_strings_mod_matches_jax_and_plain(nb):
    toks = TOKENS + _rand_tokens(200, nb % 97)
    got = fg.hash_strings_mod(toks, nb, threads=2)
    assert got.dtype == np.int64 and got.shape == (len(toks),)
    np.testing.assert_array_equal(got, jax_fg.hash_strings_mod(toks, nb))
    np.testing.assert_array_equal(got, fg.np_hash_strings_mod(toks, nb))
    assert fg.hash_strings_mod([], nb).shape == (0,)


def test_hash_ints_mod_matches_jax_and_plain():
    rng = np.random.default_rng(0)
    vals = np.concatenate([rng.integers(-(1 << 62), 1 << 62, 500),
                           [0, -1, np.iinfo(np.int64).min,
                            np.iinfo(np.int64).max]])
    for nb in (13, 1 << 33):
        got = fg.hash_ints_mod(vals, nb)
        np.testing.assert_array_equal(got, jax_fg.hash_ints_mod(vals, nb))
        np.testing.assert_array_equal(got, fg.np_hash_ints_mod(vals, nb))
        # the bytes of the decimal string
        np.testing.assert_array_equal(
            got, fg.hash_strings_mod([str(v) for v in vals], nb))


def test_bucketize_matches_jax_and_plain():
    rng = np.random.default_rng(1)
    vals = np.concatenate([rng.normal(size=3000), [np.inf, -np.inf]])
    bounds = np.sort(rng.normal(size=31))
    vals[:31] = bounds  # values on a boundary go right
    got = fg.bucketize(vals, bounds)
    np.testing.assert_array_equal(got, jax_fg.bucketize(vals, bounds))
    np.testing.assert_array_equal(got, fg.np_bucketize(vals, bounds))
    assert fg.bucketize(np.zeros(0), bounds).shape == (0,)


def _cells(seed, n=300, delim=None):
    rng = np.random.default_rng(seed)
    cells = []
    for _ in range(n):
        r = rng.random()
        if r < 0.08:
            cells.append(None)
        elif r < 0.15:
            cells.append("")
        else:
            toks = _rand_tokens(int(rng.integers(1, 5)), int(rng.integers(
                1 << 30)))
            if rng.random() < 0.1:
                toks.append("y" * 300)
            sep = delim if delim and rng.random() < 0.5 else ","
            cells.append(sep.join(toks))
    return cells


@pytest.mark.parametrize("sliced", [False, True])
def test_split_hash_matches_jax_and_plain(sliced):
    arr = pa.array(_cells(2) + ["a,,b", ",", "solo", "新,疆"])
    if sliced:
        arr = arr.slice(5, 250)
    assert fg.split_hash_ok(arr, ",")
    vals, lengths = fg.split_hash_arrow(arr, ",", 1000)
    jvals, jlengths = jax_fg.split_hash_arrow(arr, ",", 1000)
    pvals, plengths = fg.np_split_hash(arr, ",", 1000)
    np.testing.assert_array_equal(lengths, jlengths)
    np.testing.assert_array_equal(vals, jvals)
    np.testing.assert_array_equal(lengths, plengths)
    np.testing.assert_array_equal(vals, pvals)
    assert int(lengths.sum()) == len(vals)


def test_split_hash_routes_what_it_cannot_take():
    """A non-string column or a longer separator is decided up front: the
    wrapper refuses it (the feature parses it in Python)."""
    assert not fg.split_hash_ok(pa.array([1, 2]), ",")
    assert not fg.split_hash_ok(pa.array(["a"]), "::")
    assert jax_fg.split_hash_arrow(pa.array(["a"]), "::", 10) is None
    with pytest.raises(ValueError):
        fg.split_hash_arrow(pa.array([1, 2]), ",", 10)


def test_seq_split_hash_matches_jax_and_plain():
    cells = [c or "" for c in _cells(3, delim=";")]
    cells += [";;", "a;", ";b", "a,b;c", "é;中,文", ";" * 40]
    arr = pa.array(cells)
    assert fg.seq_split_hash_ok(arr, ";", ",")
    got = fg.seq_split_hash_arrow(arr, ";", ",", 5000)
    ref = fg.np_seq_split_hash(arr, ";", ",", 5000)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)
    # the JAX wrapper sizes its step buffer by the bytes and hands a row
    # of many empty steps back (None); compare where it takes the input
    jgot = jax_fg.seq_split_hash_arrow(pa.array(cells[:-1]), ";", ",", 5000)
    for g, r in zip(fg.seq_split_hash_arrow(pa.array(cells[:-1]), ";", ",",
                                            5000), jgot):
        np.testing.assert_array_equal(g, r)
    assert not fg.seq_split_hash_ok(pa.array(["a", None]), ";", ",")


_BUILD = r"""
import sys
sys.path.insert(0, {repo!r})
from torcheasyrec_tpu_torch import fg
fg.BUILD_DIR = __import__("pathlib").Path({build!r})
print(fg.load().fg_version(), fg.hash_strings_mod(["abc"], 1000)[0])
"""


def test_concurrent_builds_both_load(tmp_path):
    """Two processes build the library into one directory at once; each
    writes a name of its own and renames it into place, so both load a
    whole library."""
    code = _BUILD.format(repo=REPO, build=str(tmp_path))
    procs = [subprocess.Popen([sys.executable, "-c", code],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    want = f"1 {int(fg.np_hash_strings_mod(['abc'], 1000)[0])}"
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
        assert out.strip() == want
    libs = [f for f in os.listdir(tmp_path) if f.endswith(".so")]
    assert libs == [fg.library_path().name]
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".tmp")]


def test_failed_build_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(fg, "BUILD_DIR", tmp_path)
    with pytest.raises(RuntimeError, match="failed"):
        fg.build(cxx="false")
    assert os.listdir(tmp_path) == []
