"""The port's SID tools and their libraries against the JAX package's,
exact (numpy on the host in both; every output equal).

- ``utils/sid/collision.py``: the SplitMix64 order hash, the random
  candidates, ``resolve_collisions`` under the candidate and the random
  strategies (resolved codes, slots, unresolved and overflow rows,
  stats) and ``group_items``, on seeded SID tables with heavy
  collisions; ``utils/sid/quality.py``: the accumulator's metrics,
  layer metrics and top SIDs streamed over batches, the before/after
  delta, Gini, entropy and the valid-row mask.
- ``tools/sid/resolve_sid_collisions.py`` and
  ``tools/sid/evaluate_sid_quality.py`` end to end through their
  argument parsers, from a parquet SID table (``codes`` list<int64>,
  ``candidate_codes``), writing parquet and CSV: every output file equal
  to the JAX tool's. A CSV input (headerless to the tools' reader, which
  they cannot give ``input_fields``) is refused by both alike.
"""

import dataclasses
import os
import sys
from unittest import mock

import numpy as np
import pyarrow as pa
import pyarrow.csv as pacsv
import pyarrow.parquet as pq
import pytest

from torcheasyrec_tpu.tools.sid import evaluate_sid_quality as jax_eval
from torcheasyrec_tpu.tools.sid import resolve_sid_collisions as jax_resolve
from torcheasyrec_tpu.utils.sid import collision as jax_collision
from torcheasyrec_tpu.utils.sid import quality as jax_quality
from torcheasyrec_tpu_torch.tools.sid import evaluate_sid_quality as port_eval
from torcheasyrec_tpu_torch.tools.sid import (
    resolve_sid_collisions as port_resolve,
)
from torcheasyrec_tpu_torch.utils.sid import collision as port_collision
from torcheasyrec_tpu_torch.utils.sid import quality as port_quality

LAYERS = [8, 4, 16]
TOPK = 4


def sid_table(n: int, seed: int, string_ids: bool = False):
    """(item ids, codes [n, 3], candidate codes [n, TOPK * 3]) with most
    rows in a few crowded buckets."""
    r = np.random.default_rng(seed)
    ids = r.permutation(n * 3)[:n].astype(np.int64)
    if string_ids:
        ids = np.asarray([f"item_{v}" for v in ids])
    codes = np.stack([r.integers(0, 2, n), r.integers(0, 2, n),
                      r.integers(0, 3, n)], axis=1).astype(np.int64)
    cands = np.stack([r.integers(0, s, (n, TOPK)) for s in LAYERS],
                     axis=2).reshape(n, TOPK * len(LAYERS)).astype(np.int64)
    return ids, codes, cands


def _result_fields(res):
    return {f.name: getattr(res, f.name)
            for f in dataclasses.fields(res)}


def _assert_equal_results(a, b):
    fa, fb = _result_fields(a), _result_fields(b)
    assert list(fa) == list(fb)
    for k in fa:
        if isinstance(fa[k], np.ndarray):
            np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)
        else:
            assert _result_fields(fa[k]) == _result_fields(fb[k]), k


@pytest.mark.parametrize("case", ["candidate", "random", "string_ids",
                                  "capacity_3"])
def test_collision_library_matches_jax(case):
    ids, codes, cands = sid_table(400, 1, string_ids=case == "string_ids")
    cap = 3 if case == "capacity_3" else 1
    if case == "random":
        kw = {"num_random_candidates": 5}
    else:
        kw = {"candidate_last_codes": cands[:, len(LAYERS) - 1::len(LAYERS)]}
    if case != "string_ids":
        np.testing.assert_array_equal(
            port_collision.stable_order_hash(ids),
            jax_collision.stable_order_hash(ids))
        np.testing.assert_array_equal(
            port_collision.random_candidates(ids, 16, 7),
            jax_collision.random_candidates(ids, 16, 7))
    ours = port_collision.resolve_collisions(ids, codes, LAYERS, cap, **kw)
    ref = jax_collision.resolve_collisions(ids, codes, LAYERS, cap, **kw)
    _assert_equal_results(ours, ref)
    assert ours.overflow_rows.size > 0
    for last in (None, ours.resolved_last_codes):
        for a, b in zip(port_collision.group_items(ids, codes, LAYERS, last),
                        jax_collision.group_items(ids, codes, LAYERS, last)):
            np.testing.assert_array_equal(a, b)


def test_quality_library_matches_jax():
    _, codes, _ = sid_table(500, 2)
    _, other, _ = sid_table(500, 3)
    results = []
    for mod in (port_quality, jax_quality):
        acc = mod.SidQualityAccumulator(LAYERS, top_sids=4)
        acc.update(codes[:200])
        acc.update(codes[200:])
        before = mod.SidQualityAccumulator(LAYERS, top_sids=4)
        before.update(other)
        after = acc.finalize()
        delta = mod.compare_sid_quality(before.finalize(), after)
        # the classes differ: compare the fields
        results.append((dataclasses.asdict(after), dataclasses.asdict(delta)))
    assert results[0] == results[1]
    assert results[0][0]["top_sids"]
    counts = np.bincount(codes[:, 2], minlength=16)
    assert port_quality.compute_gini(counts) == jax_quality.compute_gini(
        counts)
    assert port_quality.compute_entropy(counts) == (
        jax_quality.compute_entropy(counts))
    bad = codes.copy()
    bad[::7, 1] = 9
    np.testing.assert_array_equal(port_quality.valid_code_rows(bad, LAYERS),
                                  jax_quality.valid_code_rows(bad, LAYERS))


# --- the CLIs ----------------------------------------------------------------


@pytest.fixture(scope="module")
def sid_inputs(tmp_path_factory):
    root = tmp_path_factory.mktemp("sid_tools")
    ids, codes, cands = sid_table(600, 4)
    parquet = str(root / "sid.parquet")
    pq.write_table(pa.table({
        "item_id": pa.array(ids),
        "codes": pa.array(codes.tolist(), pa.list_(pa.int64())),
        "candidate_codes": pa.array(cands.tolist(), pa.list_(pa.int64())),
        "resolved": pa.array(codes[:, ::-1].copy().tolist(),
                             pa.list_(pa.int64())),
    }), parquet)
    csv = str(root / "sid.csv")
    pacsv.write_csv(pa.table({
        "item_id": pa.array(ids),
        "codes": pa.array([",".join(map(str, c)) for c in codes.tolist()]),
        "candidate_codes": pa.array(
            [",".join(map(str, c)) for c in cands.tolist()]),
    }), csv)
    return str(root), {"parquet": parquet, "csv": csv}


def _read(path):
    if path.endswith(".csv") or os.path.exists(
            os.path.join(path, "part-0.csv")):
        p = path if path.endswith(".csv") else os.path.join(path,
                                                            "part-0.csv")
        with open(p) as f:
            return f.read()
    return pq.read_table(os.path.join(path, "part-0.parquet"))


@pytest.mark.parametrize("src,strategy,writer", [
    ("parquet", "candidate", "ParquetWriter"),
    ("parquet", "random", "CsvWriter"),
    ("parquet", "candidate", "CsvWriter"),
    ("csv", "random", "ParquetWriter"),
])
def test_resolve_sid_collisions_cli_matches_jax(sid_inputs, src, strategy,
                                                writer):
    root, inputs = sid_inputs
    outs = {}
    for name, mod in (("port", port_resolve), ("jax", jax_resolve)):
        d = os.path.join(root, f"resolve_{src}_{strategy}_{name}")
        args = mod.build_parser().parse_args([
            "--input_path", inputs[src], "--codebook",
            ",".join(map(str, LAYERS)), "--max_items_per_codebook", "2",
            "--strategy", strategy, "--num_random_candidates", "6",
            "--writer_type", writer,
            "--output_path", os.path.join(d, "map"),
            "--resolved_sid_groups_output_path", os.path.join(d, "resolved"),
            "--original_sid_groups_output_path", os.path.join(d, "original"),
        ])
        if src == "csv":
            # the tools read a CSV without a header, which needs
            # input_fields they cannot be given: both packages refuse it
            with pytest.raises(ValueError, match="input_fields"):
                mod.run(args)
            continue
        stats = mod.run(args).stats
        outs[name] = (dataclasses.asdict(stats), [
            _read(os.path.join(d, k)) for k in ("map", "resolved",
                                                "original")])
    if src == "csv":
        return
    assert outs["port"][0] == outs["jax"][0]
    assert outs["port"][0]["relocated_count"] > 0
    for a, b in zip(outs["port"][1], outs["jax"][1]):
        assert a.equals(b) if isinstance(a, pa.Table) else a == b


@pytest.mark.parametrize("src,writer,compare", [
    ("parquet", "ParquetWriter", True),
    ("parquet", "CsvWriter", False),
    ("parquet", "CsvWriter", True),
])
def test_evaluate_sid_quality_cli_matches_jax(sid_inputs, src, writer,
                                              compare):
    root, inputs = sid_inputs
    outs = {}
    for name, mod in (("port", port_eval), ("jax", jax_eval)):
        d = os.path.join(root, f"quality_{src}_{writer}_{compare}_{name}")
        argv = ["evaluate_sid_quality", "--input_path", inputs[src],
                "--codebook", ",".join(map(str, LAYERS)), "--top_sids", "3",
                "--writer_type", writer,
                "--summary_output", os.path.join(d, "summary"),
                "--layer_stats_output", os.path.join(d, "layers")]
        if compare:
            argv += ["--codes_field", "resolved",
                     "--original_codes_field", "codes"]
        with mock.patch.object(sys, "argv", argv):
            mod.main()
        outs[name] = [_read(os.path.join(d, k)) for k in ("summary",
                                                          "layers")]
    for a, b in zip(outs["port"], outs["jax"]):
        assert a.equals(b) if isinstance(a, pa.Table) else a == b
    if writer == "ParquetWriter":
        views = outs["port"][0].column("view").to_pylist()
        assert views == (["before", "after", "delta"] if compare
                         else ["after"])
