"""The port's CSV reader and writer against the JAX package's, exact.

- ``CsvReader`` on the same files, every batch column for column (the
  checkpoint columns included): with a header; without one, the names
  and two column types from ``input_fields``; a directory, a glob and a
  comma list; drop_remainder, shuffle, resume inside a file; shards by
  file and by record batch (the loader's workers read those shards).
- ``CsvWriter``: the same bytes as the JAX writer, read back by both
  readers alike.
- The loader on a CSV DeepFM config (``with_header``): the parsed
  batches and their BatchInfo equal the JAX loader's, train, eval and
  predict; with two worker processes, each worker's batches equal the
  JAX dataset's shard.
- DeepFM ``train_and_evaluate`` from CSV equal, bit for bit, to the same
  rows from parquet (losses, AUC, every tensor of the checkpoint).
"""

import json
import os

import numpy as np
import pyarrow as pa
import pyarrow.csv as pacsv
import pyarrow.parquet as pq
import pytest
import torch
from google.protobuf import text_format

from test_torch_port_dataset import _assert_batch_equal
from torch_port_helpers import deepfm_cols, deepfm_config_text
from torcheasyrec_tpu.datasets import dataset as jax_dataset
from torcheasyrec_tpu.datasets.csv_dataset import CsvReader as JaxReader
from torcheasyrec_tpu.datasets.csv_dataset import CsvWriter as JaxWriter
from torcheasyrec_tpu.features import create_features as jax_features
from torcheasyrec_tpu.protos import data_pb2 as jax_data_pb2
from torcheasyrec_tpu.protos import pipeline_pb2 as jax_pb2
from torcheasyrec_tpu_torch import main as port_main
from torcheasyrec_tpu_torch.datasets import dataset as port_dataset
from torcheasyrec_tpu_torch.datasets.csv_dataset import CsvReader, CsvWriter
from torcheasyrec_tpu_torch.datasets.utils import CKPT_ROW_IDX, CKPT_SOURCE_ID
from torcheasyrec_tpu_torch.features import create_features
from torcheasyrec_tpu_torch.protos import data_pb2
from torcheasyrec_tpu_torch.utils import checkpoint_util
from torcheasyrec_tpu_torch.utils.config_util import parse_pipeline_config

SIZES = (37, 61, 23)  # rows per file: uneven, none a multiple of a batch
FIELDS = (("x", None), ("f", 4), ("s", None), ("cost", 3))  # DOUBLE, FLOAT


def _write(directory, sizes=SIZES, seed=0, header=True):
    """Files ``part-<i>.csv``: a global row id ``x``, a float, a string
    and a cost column."""
    os.makedirs(directory, exist_ok=True)
    r = np.random.default_rng(seed)
    start, paths = 0, []
    for i, n in enumerate(sizes):
        path = os.path.join(directory, f"part-{i}.csv")
        pacsv.write_csv(pa.table({
            "x": pa.array(np.arange(start, start + n, dtype=np.int64)),
            "f": pa.array(r.normal(size=n).astype(np.float32)),
            "s": pa.array([f"v{j}" for j in r.integers(0, 9, n)]),
            "cost": pa.array(r.integers(1, 6, n).astype(np.float32)),
        }), path, write_options=pacsv.WriteOptions(include_header=header))
        paths.append(path)
        start += n
    return paths


def _fields(pb2):
    out = []
    for name, t in FIELDS:
        f = pb2.Field(input_name=name)
        if t is not None:
            f.input_type = t
        out.append(f)
    return out


def _rows(batches):
    return [[(k, v.to_pylist()) for k, v in b.items()] for b in batches]


def _both(path, batch_size, worker_id=0, num_workers=1, state=None,
          headerless=False, **kw):
    out = []
    for cls, pb2 in ((JaxReader, jax_data_pb2), (CsvReader, data_pb2)):
        extra = ({"input_fields": _fields(pb2)} if headerless
                 else {"with_header": True})
        reader = cls(path, batch_size, **extra, **kw)
        if state:
            reader.load_state(state)
        out.append(_rows(reader.to_batches(worker_id, num_workers)))
    return out


@pytest.fixture(scope="module")
def csv_files(tmp_path_factory):
    root = tmp_path_factory.mktemp("csv")
    d, bare = str(root / "header"), str(root / "bare")
    return {"dir": d, "paths": _write(d), "bare": bare,
            "bare_paths": _write(bare, header=False)}


READER_CASES = {
    "dir": dict(batch_size=16),
    "glob": dict(batch_size=16, path="glob"),
    "comma_list": dict(batch_size=16, path="list"),
    "headerless_input_fields": dict(batch_size=16, headerless=True),
    "drop_remainder": dict(batch_size=16, drop_remainder=True),
    "shuffle": dict(batch_size=8, shuffle=True, shuffle_buffer_size=3),
    "resume_in_a_file": dict(batch_size=16, state={0: 10, 1: 3}),
}


@pytest.mark.parametrize("case", sorted(READER_CASES))
def test_csv_reader_batches_equal_jax(csv_files, case):
    kw = dict(READER_CASES[case])
    where = kw.pop("path", "dir")
    d = csv_files["bare" if kw.get("headerless") else "dir"]
    path = {"dir": d, "glob": os.path.join(d, "part-*.csv"),
            "list": ",".join(csv_files["paths"][::-1])}[where]
    jax_rows, rows = _both(path, kw.pop("batch_size"), **kw)
    assert rows == jax_rows and rows
    assert [k for k, _ in rows[0]] == ["x", "f", "s", "cost",
                                       CKPT_SOURCE_ID, CKPT_ROW_IDX]
    if kw.get("headerless"):
        # input_type FLOAT and DOUBLE override Arrow's inference
        reader = CsvReader(d, 8, input_fields=_fields(data_pb2))
        assert reader.schema().field("cost").type == pa.float32()
        assert reader.schema().field("f").type == pa.float64()


@pytest.mark.parametrize("k,n_files", [(2, 3), (3, 2)],
                         ids=["k2_by_file", "k3_by_record_batch"])
def test_csv_reader_shards_equal_jax(tmp_path, k, n_files):
    d = str(tmp_path)
    # Arrow parses 1 MB blocks: ~25 000 rows a record batch here
    sizes = (60_000, 45_000, 900)[:n_files]
    _write(d, sizes)
    seen = []
    for w in range(k):
        jax_rows, rows = _both(d, 4096, worker_id=w, num_workers=k)
        assert rows == jax_rows and rows
        seen += [x for b in rows for x in dict(b)["x"]]
    assert sorted(seen) == list(range(sum(sizes)))


def test_csv_writer_round_trip_equals_jax(tmp_path):
    r = np.random.default_rng(1)
    cols = {"id": pa.array(np.arange(50)), "v": pa.array(r.normal(size=50)),
            "s": pa.array([f"a,b{i}" for i in range(50)])}
    texts = []
    for cls, name in ((CsvWriter, "port"), (JaxWriter, "jax")):
        w = cls(str(tmp_path / name))
        w.write({k: v.slice(0, 20) for k, v in cols.items()})
        w.write({k: v.slice(20) for k, v in cols.items()})
        w.close()
        with open(tmp_path / name / "part-0.csv") as f:
            texts.append(f.read())
    assert texts[0] == texts[1]
    back = CsvReader(str(tmp_path / "port"), 100, with_header=True)
    jback = JaxReader(str(tmp_path / "jax"), 100, with_header=True)
    assert _rows(back.to_batches()) == _rows(jback.to_batches())
    got = pa.Table.from_pydict(dict(next(back.to_batches())))
    assert got.column("s").to_pylist() == cols["s"].to_pylist()
    assert got.column("v").to_pylist() == cols["v"].to_pylist()


# --- the loader and the training loop --------------------------------------------


def _csv_text(batch=32, train="unused", evalp="unused", model_dir="unused",
              num_steps=0):
    text = deepfm_config_text(batch, model_dir=model_dir,
                              num_steps=num_steps,
                              train_extra="  use_tensorboard: false")
    return text.replace(
        'train_input_path: "unused"', f'train_input_path: "{train}"').replace(
        'eval_input_path: "unused"', f'eval_input_path: "{evalp}"')


@pytest.fixture(scope="module")
def deepfm_inputs(tmp_path_factory):
    """The same DeepFM rows as CSV files and as parquet files."""
    root = tmp_path_factory.mktemp("deepfm_csv")
    out = {}
    for kind in ("csv", "parquet"):
        os.makedirs(root / kind)
    for i, (n, seed) in enumerate(((150, 50), (106, 51), (120, 52))):
        tbl = pa.table(deepfm_cols(n, seed=seed))
        name = "eval" if i == 2 else f"train-{i}"
        pacsv.write_csv(tbl, str(root / "csv" / f"{name}.csv"))
        pq.write_table(tbl, str(root / "parquet" / f"{name}.parquet"))
    for kind in ("csv", "parquet"):
        out[kind] = (str(root / kind / f"train-*.{kind}"),
                     str(root / kind / f"eval.{kind}"))
    return str(root), out


@pytest.mark.parametrize("mode", ["train", "eval", "predict"])
def test_csv_loader_batches_equal_jax(deepfm_inputs, mode):
    _, paths = deepfm_inputs
    text = _csv_text().replace("dataset_type: ParquetDataset",
                               "dataset_type: CsvDataset\n  with_header: true")
    cfg = parse_pipeline_config(text)
    jcfg = text_format.Parse(text, jax_pb2.EasyRecConfig())
    path = paths["csv"][0]
    ours = list(port_dataset.create_dataloader(
        cfg.data_config, create_features(list(cfg.feature_configs)), path,
        mode=mode, device="cpu", resume_state={0: 20})())
    ref = list(jax_dataset.create_dataloader(
        jcfg.data_config, jax_features(list(jcfg.feature_configs)), path,
        mode=mode, worker_id=0, num_workers=1, resume_state={0: 20})())
    assert len(ours) == len(ref) > 1
    for (batch, info), (jbatch, jinfo) in zip(ours, ref):
        _assert_batch_equal(batch, jbatch)
        assert info.checkpoint_info == jinfo.checkpoint_info
        assert info.batch_size == jinfo.batch_size


def test_csv_loader_workers_equal_jax_shards(deepfm_inputs):
    """Two worker processes over the two CSV train files: the batches of
    worker w's file are, in order, the JAX dataset's shard w of 2."""
    _, paths = deepfm_inputs
    text = _csv_text().replace(
        "dataset_type: ParquetDataset",
        "dataset_type: CsvDataset\n  with_header: true\n  num_workers: 2")
    cfg = parse_pipeline_config(text)
    # the JAX side: each shard in one process
    jcfg = text_format.Parse(text.replace("  num_workers: 2", ""),
                             jax_pb2.EasyRecConfig())
    dl = port_dataset.create_dataloader(
        cfg.data_config, create_features(list(cfg.feature_configs)),
        paths["csv"][0], mode="eval", device="cpu")
    assert dl.mp_workers == 2
    it = dl()
    try:
        got = list(it)
    finally:
        it.close()
    for w in range(2):
        mine = [(b, i) for b, i in got
                if all(src % 2 == w for src in i.checkpoint_info)]
        ref = list(jax_dataset.create_dataloader(
            jcfg.data_config, jax_features(list(jcfg.feature_configs)),
            paths["csv"][0], mode="eval", worker_id=w, num_workers=2)())
        assert [i.checkpoint_info for _, i in mine] == [
            i.checkpoint_info for _, i in ref] and mine
        for (batch, _), (jbatch, _) in zip(mine, ref):
            _assert_batch_equal(batch, jbatch)
    assert sum(i.batch_size for _, i in got) == 256


def test_deepfm_train_and_evaluate_from_csv_equals_parquet(deepfm_inputs):
    root, paths = deepfm_inputs
    results, states = {}, {}
    for kind in ("csv", "parquet"):
        train, evalp = paths[kind]
        model_dir = os.path.join(root, f"model_{kind}")
        text = _csv_text(32, train, evalp, model_dir, num_steps=6)
        if kind == "csv":
            text = text.replace("dataset_type: ParquetDataset",
                                "dataset_type: CsvDataset\n"
                                "  with_header: true")
        cfg = os.path.join(root, f"{kind}.config")
        with open(cfg, "w") as f:
            f.write(text)
        results[kind] = port_main.train_and_evaluate(cfg, device="cpu")
        states[kind] = torch.load(
            checkpoint_util.latest_checkpoint(model_dir), map_location="cpu",
            weights_only=True)
    assert results["csv"] == results["parquet"]
    assert results["csv"]["step"] == 6.0 and "auc" in results["csv"]
    a, b = states["csv"]["model"], states["parquet"]["model"]
    assert set(a) == set(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert json.dumps(states["csv"]["dataloader_state"], sort_keys=True) == (
        json.dumps(states["parquet"]["dataloader_state"], sort_keys=True))
