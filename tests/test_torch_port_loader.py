"""The port's loader processes and threads (CPU): ``DataLoader`` workers
against the JAX package's per-shard dataset, a worker's error in the
consumer, the resumed epoch on one stream, and closing an abandoned
prefetch thread. Order across workers is never asserted: only each
worker's own stream has an order."""

import itertools
import os
import time

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
from google.protobuf import text_format

from torch_port_helpers import deepfm_cols, deepfm_config_text
from torcheasyrec_tpu.datasets import dataset as jax_dataset
from torcheasyrec_tpu.features import create_features as jax_features
from torcheasyrec_tpu.protos import pipeline_pb2 as jax_pb2
from torcheasyrec_tpu_torch.datasets import dataset as port_dataset
from torcheasyrec_tpu_torch.datasets.utils import Batch, BatchInfo
from torcheasyrec_tpu_torch.features import create_features
from torcheasyrec_tpu_torch.utils.config_util import parse_pipeline_config

BATCH = 16
SIZES = (41, 30, 27)


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("loader"))
    for i, n in enumerate(SIZES):
        pq.write_table(pa.table(deepfm_cols(n, seed=40 + i)),
                       os.path.join(d, f"part-{i}.parquet"),
                       row_group_size=8)
    return d


def _text(num_workers=None):
    text = deepfm_config_text(BATCH)
    if num_workers is not None:
        text = text.replace(f"  batch_size: {BATCH}",
                            f"  batch_size: {BATCH}\n"
                            f"  num_workers: {num_workers}")
    return text


def _port_dl(text, path, mode="eval", **kw):
    cfg = parse_pipeline_config(text)
    return port_dataset.create_dataloader(
        cfg.data_config, create_features(list(cfg.feature_configs)), path,
        mode=mode, device="cpu", **kw)


def _jax_shard(text, path, mode, w, k):
    jcfg = text_format.Parse(text, jax_pb2.EasyRecConfig())
    dl = jax_dataset.create_dataloader(
        jcfg.data_config, jax_features(list(jcfg.feature_configs)), path,
        mode=mode, worker_id=w, num_workers=k)
    return [(b, i) for b, i in dl()]


def _ids(batch):
    return {k: f.values.numpy().tolist()
            for k, f in batch.sparse_features.items()}


def test_worker_shards_equal_jax_shards(data_dir):
    """Two worker processes: the batches whose sources belong to worker
    w's files (file i goes to worker i % 2) are, in order, the JAX
    dataset's shard w of 2; together the workers give every row of the
    single stream once."""
    text = _text(num_workers=2)
    dl = _port_dl(text, data_dir)
    assert dl.mp_workers == 2
    it = dl()
    assert isinstance(it, port_dataset._LoaderIter)
    try:
        got = list(it)
    finally:
        it.close()
    total = 0
    for w in range(2):
        mine = [(b, i) for b, i in got
                if all(s % 2 == w for s in i.checkpoint_info)]
        ref = _jax_shard(_text(), data_dir, "eval", w, 2)
        assert [i.checkpoint_info for _, i in mine] == [
            i.checkpoint_info for _, i in ref]
        for (b, _), (jb, _) in zip(mine, ref):
            assert isinstance(b, Batch)
            assert _ids(b) == {k: np.asarray(f.values).tolist()
                               for k, f in jb.sparse_features.items()}
        total += len(mine)
    assert total == len(got)
    single = list(_port_dl(_text(), data_dir)())
    assert sum(i.batch_size for _, i in got) == sum(
        i.batch_size for _, i in single) == sum(SIZES)


def test_worker_error_raises_in_the_consumer(data_dir, tmp_path):
    """A file that is not parquet fails its worker's read; the consumer
    raises it, well inside the DataLoader's timeout. The file sorts first:
    each worker reads the input's schema from it before anything else, so
    the first item the consumer asks for is the error, with no batch of
    either worker before it (the error no longer waits on a worker's
    progress through other files)."""
    d = str(tmp_path)
    for name in os.listdir(data_dir):
        os.symlink(os.path.join(data_dir, name), os.path.join(d, name))
    with open(os.path.join(d, "bad-0.parquet"), "wb") as f:
        f.write(b"not parquet at all")
    it = _port_dl(_text(num_workers=2), d)()
    t0 = time.perf_counter()
    try:
        with pytest.raises(Exception, match="(?i)parquet"):
            list(it)
    finally:
        it.close()
    assert time.perf_counter() - t0 < port_dataset.WORKER_TIMEOUT_S


def test_resumed_epoch_runs_single_stream(data_dir):
    """With a resume state, the first epoch runs on the thread loader from
    the watermark; the next epoch runs the workers over every row."""
    dl = _port_dl(_text(num_workers=2), data_dir, mode="train",
                  resume_state={0: 40, 1: 9})
    first = dl()
    assert isinstance(first, port_dataset.PrefetchIterator)
    rows = [i.checkpoint_info for _, i in first]
    first.close()
    # 10 rows of file 1 and 27 of file 2 remain: 2 batches, the rest dropped
    assert rows == [{1: 25}, {1: 29, 2: 11}]
    second = dl()
    assert isinstance(second, port_dataset._LoaderIter)
    try:
        n = sum(i.batch_size for _, i in second)
    finally:
        second.close()
    # each worker drops its own remainder: (41 + 27) // 16 + 30 // 16 batches
    assert n == BATCH * (68 // BATCH + 30 // BATCH)


def test_workers_stay_off_unless_asked(monkeypatch):
    cfg = parse_pipeline_config(_text())
    assert port_dataset.num_loader_workers(cfg.data_config) == 0  # default 8
    cfg = parse_pipeline_config(_text(num_workers=3))
    assert port_dataset.num_loader_workers(cfg.data_config) == 3
    assert port_dataset.num_loader_workers(cfg.data_config, "predict") == 0
    monkeypatch.setenv("TZREC_MP_LOADER", "0")
    assert port_dataset.num_loader_workers(cfg.data_config) == 0


def test_prefetch_close_on_an_abandoned_iterator_returns():
    """The thread is blocked on a full queue of an endless stream when the
    consumer walks away; close() stops it."""
    endless = ((Batch(), BatchInfo(batch_size=i)) for i in itertools.count())
    it = port_dataset.PrefetchIterator(endless, prefetch=1)
    assert next(it)[1].batch_size == 0
    time.sleep(0.1)
    t0 = time.perf_counter()
    it.close()
    assert not it._t.is_alive()
    assert time.perf_counter() - t0 < 5


def test_prefetch_reraises_the_producer_error():
    def failing():
        yield Batch(), BatchInfo(batch_size=1)
        raise ValueError("bad row group")

    it = port_dataset.PrefetchIterator(failing())
    assert next(it)[1].batch_size == 1
    with pytest.raises(ValueError, match="bad row group"):
        next(it)
    with pytest.raises(StopIteration):
        next(it)
