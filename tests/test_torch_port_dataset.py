"""The port's parquet reader and dataset against the JAX package's, on
the same files: every batch column for column and exactly, the two
checkpoint columns included, over several files of uneven size with
small row groups (directories, globs and comma lists; train, eval and
predict; drop_remainder, shuffle, cost-capped batches; shards by file
and by row group; a resume inside a row group); then the parsed
batches and their BatchInfo. One test per repaired fault of the port's
old per-file reading (F1-F4)."""

import os

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch
from google.protobuf import text_format

from torch_port_helpers import deepfm_cols, deepfm_config_text
from torcheasyrec_tpu.datasets import dataset as jax_dataset
from torcheasyrec_tpu.datasets.parquet_dataset import (
    ParquetReader as JaxReader,
)
from torcheasyrec_tpu.datasets.parquet_dataset import (
    _expand_paths as jax_expand,
)
from torcheasyrec_tpu.features import create_features as jax_features
from torcheasyrec_tpu.protos import pipeline_pb2 as jax_pb2
from torcheasyrec_tpu_torch.datasets import dataset as port_dataset
from torcheasyrec_tpu_torch.datasets.parquet_dataset import (
    ParquetReader,
    _expand_paths,
)
from torcheasyrec_tpu_torch.datasets.utils import CKPT_ROW_IDX, CKPT_SOURCE_ID
from torcheasyrec_tpu_torch.features import create_features
from torcheasyrec_tpu_torch.utils.config_util import parse_pipeline_config

SIZES = (37, 61, 23)  # rows per file: uneven, none a multiple of a batch


def _write(directory, sizes=SIZES, row_group_size=7, seed=0, prefix="part"):
    """Files ``<prefix>-<i>.parquet`` of ``sizes`` rows: a global row id
    ``x``, a float, a string and a cost column, row groups of
    ``row_group_size``."""
    os.makedirs(directory, exist_ok=True)
    r = np.random.default_rng(seed)
    start, paths = 0, []
    for i, n in enumerate(sizes):
        path = os.path.join(directory, f"{prefix}-{i}.parquet")
        pq.write_table(pa.table({
            "x": pa.array(np.arange(start, start + n, dtype=np.int64)),
            "f": pa.array(r.normal(size=n).astype(np.float32)),
            "s": pa.array([f"v{j}" for j in r.integers(0, 9, n)]),
            "cost": pa.array(r.integers(1, 6, n).astype(np.float32)),
        }), path, row_group_size=row_group_size)
        paths.append(path)
        start += n
    return paths


def _rows(batches):
    """Each batch as {column: python list}, in column order."""
    return [[(k, v.to_pylist()) for k, v in b.items()] for b in batches]


def _both(path, batch_size, worker_id=0, num_workers=1, state=None, **kw):
    out = []
    for cls in (JaxReader, ParquetReader):
        reader = cls(path, batch_size, **kw)
        if state:
            reader.load_state(state)
        out.append(_rows(reader.to_batches(worker_id, num_workers)))
    return out


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("parquet"))
    return d, _write(d)


READER_CASES = {
    "plain": dict(batch_size=16),
    "drop_remainder": dict(batch_size=16, drop_remainder=True),
    "batch_larger_than_a_file": dict(batch_size=50),
    "shuffle": dict(batch_size=8, shuffle=True, shuffle_buffer_size=3),
    "shuffle_pool_larger_than_input": dict(batch_size=8, shuffle=True,
                                           shuffle_buffer_size=64),
    "cost_capped": dict(batch_size=16, sample_cost_field="cost",
                        batch_cost_size=20),
    "selected_cols": dict(batch_size=16, selected_cols=["s", "x", "nope"]),
    "resume_in_a_row_group": dict(batch_size=16, state={0: 10, 1: 3}),
    "resume_past_a_file": dict(batch_size=16, state={0: 36, 2: 13}),
}


@pytest.mark.parametrize("case", sorted(READER_CASES))
def test_reader_batches_equal_jax(files, case):
    d, _ = files
    kw = dict(READER_CASES[case])
    jax_rows, rows = _both(d, kw.pop("batch_size"), **kw)
    assert rows == jax_rows
    names = [k for k, _ in rows[0]]
    assert names[-2:] == [CKPT_SOURCE_ID, CKPT_ROW_IDX]


@pytest.mark.parametrize("k,sizes", [(2, SIZES), (3, SIZES[:2])],
                         ids=["k2_by_file", "k3_by_row_group"])
def test_reader_shards_equal_jax(tmp_path, k, sizes):
    """k = 2 over 3 files shards by file, k = 3 over 2 files by row
    group; each shard equals the JAX one and together they hold every
    row once."""
    d = str(tmp_path)
    _write(d, sizes)
    seen = []
    for w in range(k):
        jax_rows, rows = _both(d, 8, worker_id=w, num_workers=k)
        assert rows == jax_rows and rows
        seen += [x for b in rows for x in dict(b)["x"]]
    assert sorted(seen) == list(range(sum(sizes)))


def test_expand_paths_equals_jax(tmp_path):
    """A directory (recursive, sorted), a glob and a comma list of both
    name the same files in the same order; a pattern that matches nothing
    raises in both."""
    d = str(tmp_path)
    _write(os.path.join(d, "a"), (5, 6), prefix="p")
    _write(os.path.join(d, "a", "sub"), (4,), prefix="q")
    _write(os.path.join(d, "b"), (3, 2), prefix="r")
    for spec in (os.path.join(d, "a"), os.path.join(d, "b", "r-*.parquet"),
                 f"{os.path.join(d, 'b')}, {os.path.join(d, 'a', 'p-1.parquet')}"
                 f",{os.path.join(d, 'a', 'p-?.parquet')}"):
        assert _expand_paths(spec) == jax_expand(spec)
    assert len(_expand_paths(os.path.join(d, "a"))) == 3
    for nothing in (os.path.join(d, "none-*.parquet"),
                    os.path.join(d, "empty") + ",",):
        os.makedirs(os.path.join(d, "empty"), exist_ok=True)
        with pytest.raises(FileNotFoundError):
            jax_expand(nothing)
        with pytest.raises(FileNotFoundError):
            _expand_paths(nothing)


# --- the dataset: parsed batches and BatchInfo -------------------------------
BATCH = 32


def _configs(text):
    return (parse_pipeline_config(text),
            text_format.Parse(text, jax_pb2.EasyRecConfig()))


@pytest.fixture(scope="module")
def deepfm_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("deepfm"))
    start = 0
    for i, n in enumerate((45, 70, 29)):
        cols = deepfm_cols(n, seed=20 + i)
        cols["rid"] = pa.array(np.arange(start, start + n, dtype=np.int64))
        pq.write_table(pa.table(cols), os.path.join(d, f"part-{i}.parquet"),
                       row_group_size=16)
        start += n
    return d


def _assert_batch_equal(batch, jbatch):
    for attr in ("dense_features", "sparse_features",
                 "sequence_sparse_features", "sequence_dense_features"):
        ours, ref = getattr(batch, attr), getattr(jbatch, attr)
        assert set(ours) == set(ref), attr
        for name, field in ours.items():
            for f in ("values", "lengths", "weights"):
                a, b = getattr(field, f, None), getattr(ref[name], f, None)
                assert (a is None) == (b is None), (name, f)
                if a is not None:
                    assert isinstance(a, torch.Tensor)
                    np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                                  err_msg=f"{name}.{f}")
    for attr in ("labels", "sample_weights"):
        ours, ref = getattr(batch, attr), getattr(jbatch, attr)
        assert set(ours) == set(ref), attr
        for name in ours:
            np.testing.assert_array_equal(ours[name].numpy(),
                                          np.asarray(ref[name]))


def _loaders(text, path, mode, **kw):
    cfg, jcfg = _configs(text)
    port = port_dataset.create_dataloader(
        cfg.data_config, create_features(list(cfg.feature_configs)), path,
        mode=mode, device="cpu", **kw)
    jax_dl = jax_dataset.create_dataloader(
        jcfg.data_config, jax_features(list(jcfg.feature_configs)), path,
        mode=mode, worker_id=0, num_workers=1, **kw)
    return list(port()), list(jax_dl())


@pytest.mark.parametrize("mode", ["train", "eval", "predict"])
def test_dataset_batches_and_info_equal_jax(deepfm_dir, mode):
    text = deepfm_config_text(BATCH).replace(
        f"  batch_size: {BATCH}", f"  batch_size: {BATCH}\n"
        "  eval_batch_size: 40")
    ours, ref = _loaders(text, deepfm_dir, mode, reserved_columns=["rid"],
                         resume_state={0: 20})
    assert len(ours) == len(ref) > 1
    for (batch, info), (jbatch, jinfo) in zip(ours, ref):
        _assert_batch_equal(batch, jbatch)
        assert info.checkpoint_info == jinfo.checkpoint_info
        assert info.batch_size == jinfo.batch_size
        assert info.data_timestamp == jinfo.data_timestamp
        assert list(info.reserved) == list(jinfo.reserved) == ["rid"]
        assert (info.reserved["rid"].to_pylist()
                == jinfo.reserved["rid"].to_pylist())
    assert (mode == "predict") == (not ours[0][0].labels)


def test_sampler_raises():
    """The loader builds the TDM sampler (tests/test_torch_port_tdm.py),
    which writes its labels into the first label field; and a negative
    sampler (tests/test_torch_port_match.py) for train and eval, none
    for predict."""
    def config(sampler):
        return parse_pipeline_config(deepfm_config_text(BATCH).replace(
            '  label_fields: "label"',
            f'  label_fields: "label"\n  label_fields: "label2"\n'
            f'  {sampler}')).data_config

    tdm = config('tdm_sampler { item_input_path: "x" edge_input_path: "x" '
                 'predict_edge_input_path: "x" attr_fields: "cat_0" '
                 'item_id_field: "cat_0" }')
    built = port_dataset.create_sampler(tdm, "train")
    assert type(built).__name__ == "TDMSampler"
    assert built._label_field == "label"
    assert port_dataset.create_sampler(tdm, "predict") is None
    neg = config('negative_sampler { input_path: "x" num_sample: 2 '
                 'attr_fields: "cat_0" item_id_field: "cat_0" }')
    assert type(port_dataset.create_sampler(neg, "train")).__name__ == (
        "NegativeSampler")
    assert port_dataset.create_sampler(neg, "predict") is None


def test_csv_input_raises():
    """CSV input is ported (tests/test_torch_port_csv.py holds it against
    the JAX package), and so is Kafka (tests/test_torch_port_kafka.py),
    which raises ImportError without ``confluent_kafka``; ODPS is a stub
    in both packages and raises NotImplementedError."""
    import sys
    from unittest import mock

    from torcheasyrec_tpu_torch.datasets.csv_dataset import CsvReader
    from torcheasyrec_tpu_torch.protos import data_pb2

    with pytest.raises(FileNotFoundError, match="no csv files"):
        port_dataset.create_reader("missing_dir/*.csv", 8)
    assert port_dataset._READER_CLASS_MAP["CsvReader"] is CsvReader
    with mock.patch.dict(sys.modules, {"confluent_kafka": None}):
        with pytest.raises(ImportError, match="confluent-kafka"):
            port_dataset.create_reader(
                "kafka://b/t", 8,
                dataset_type=data_pb2.DatasetType.Value("KafkaDataset"))
    with pytest.raises(NotImplementedError, match="OdpsDataset"):
        port_dataset.create_reader(
            "in", 8, dataset_type=data_pb2.DatasetType.Value("OdpsDataset"))


# --- one test per fault of the port's old parquet reading ---------------------
def test_f1_file_remainders_carry_into_the_next_file(tmp_path):
    """Three files of 200 rows at batch 256: two train batches, as in the
    JAX package (the old reader dropped each file's 200 rows)."""
    d = str(tmp_path)
    for i in range(3):
        pq.write_table(pa.table(deepfm_cols(200, seed=i)),
                       os.path.join(d, f"part-{i}.parquet"))
    ours, ref = _loaders(deepfm_config_text(256), d, "train")
    assert [i.batch_size for _, i in ours] == [256, 256]
    assert [i.checkpoint_info for _, i in ours] == [
        i.checkpoint_info for _, i in ref] == [{0: 199, 1: 55}, {1: 199, 2: 111}]
    for (batch, _), (jbatch, _) in zip(ours, ref):
        _assert_batch_equal(batch, jbatch)


def test_f2_directories_and_globs_are_read(deepfm_dir):
    """A directory and a glob read all three files (the old reader failed
    on both)."""
    glob_path = os.path.join(deepfm_dir, "part-*.parquet")
    for path in (deepfm_dir, glob_path):
        ours, ref = _loaders(deepfm_config_text(BATCH), path, "eval")
        assert sum(i.batch_size for _, i in ours) == 45 + 70 + 29
        assert [i.checkpoint_info for _, i in ours] == [
            i.checkpoint_info for _, i in ref]


def test_f3_eval_batch_size_is_used(deepfm_dir):
    text = deepfm_config_text(BATCH).replace(
        f"  batch_size: {BATCH}", f"  batch_size: {BATCH}\n"
        "  eval_batch_size: 50")
    for mode, sizes in (("eval", [50, 50, 44]), ("predict", [50, 50, 44]),
                        ("train", [32, 32, 32, 32])):
        ours, ref = _loaders(text, deepfm_dir, mode)
        assert [i.batch_size for _, i in ours] == sizes
        assert [i.batch_size for _, i in ref] == sizes


def test_f4_shuffle_and_drop_remainder_are_read(deepfm_dir):
    plain = deepfm_config_text(20)
    shuffled = plain.replace(
        "  batch_size: 20", "  batch_size: 20\n  shuffle: true\n"
        "  shuffle_buffer_size: 4")
    ours, ref = _loaders(shuffled, deepfm_dir, "train")
    order = [info.checkpoint_info for _, info in ours]
    assert order == [info.checkpoint_info for _, info in ref]
    unshuffled, _ = _loaders(plain, deepfm_dir, "train")
    assert order != [info.checkpoint_info for _, info in unshuffled]
    # eval never shuffles; drop_remainder drops its short last batch
    kept, _ = _loaders(shuffled, deepfm_dir, "eval")
    assert [i.checkpoint_info for _, i in kept] == [
        i.checkpoint_info for _, i in unshuffled] + [{2: 28}]
    dropped, jdropped = _loaders(
        plain.replace("  batch_size: 20",
                      "  batch_size: 20\n  drop_remainder: true"),
        deepfm_dir, "eval")
    assert [i.batch_size for _, i in dropped] == [20] * 7
    assert len(jdropped) == 7
