"""The samplers' tables in shared memory (utils/shm_pack.py), as the JAX
package's tests/test_sampler_shm.py holds its own: a pack's round trip;
a shared sampler draws exactly what an unshared one draws, and a pickled
copy (a loader worker's) carries no table, attaches to the segment and
reads no file; NegativeSamplerV2's and HardNegativeSampler's edge CSRs
and TDM's tree ride in the segment (their files moved away after
``prepare_shared``); ``close_shared`` unlinks it; and a loader with 2
worker processes and the TDM sampler gives, shard by shard, the thread
loader's batches, and leaves no segment behind."""

import os
import pickle

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
from google.protobuf import text_format

from test_torch_port_tdm import BATCH, _cols, _items, config_text
from torcheasyrec_tpu_torch.datasets import dataset as port_dataset
from torcheasyrec_tpu_torch.datasets import sampler as sampler_mod
from torcheasyrec_tpu_torch.protos import sampler_pb2
from torcheasyrec_tpu_torch.tools.tdm import gen_tree
from torcheasyrec_tpu_torch.utils import shm_pack
from torcheasyrec_tpu_torch.utils.config_util import parse_pipeline_config


class _Cfg:
    def __init__(self, path):
        self.input_path = path
        self.num_sample = 8
        self.num_eval_sample = 0
        self.attr_fields = ["item_id", "item_cat"]
        self.attr_delimiter = ":"
        self.item_id_field = "item_id"


class _V2Cfg(_Cfg):
    def __init__(self, item_path, edge_path, hard_path=""):
        super().__init__(item_path)
        self.item_input_path = item_path
        self.pos_edge_input_path = edge_path
        self.hard_neg_edge_input_path = hard_path
        self.num_hard_sample = 2
        self.user_id_field = "user_id"


@pytest.fixture()
def item_file(tmp_path):
    n = 1000
    ids = np.arange(100, 100 + n, dtype=np.int64)
    pq.write_table(pa.table({"id": ids, "weight": np.linspace(1.0, 3.0, n),
                             "attrs": [f"{i}:{i % 7}" for i in ids]}),
                   str(tmp_path / "item.parquet"))
    return str(tmp_path / "item.parquet")


@pytest.fixture()
def edge_files(tmp_path):
    """User u's positive edges (10 items) and hard edges (3 items)."""
    def write(name, pairs):
        u, i = zip(*pairs)
        pq.write_table(pa.table({"user": np.asarray(u, np.int64),
                                 "item": np.asarray(i, np.int64)}),
                       str(tmp_path / name))
        return str(tmp_path / name)

    return (write("edges.parquet", [(u, 100 + (u * 13 + j) % 400)
                                    for u in range(16) for j in range(10)]),
            write("hard.parquet", [(u, 600 + (u * 3 + j) % 100)
                                   for u in range(16) for j in range(3)]))


def _cols_of(users):
    n = len(users)
    return {"user_id": pa.array(np.asarray(users, np.int64)),
            "item_id": pa.array(np.arange(1000, 1000 + n, dtype=np.int64)),
            "item_cat": pa.array([str(i) for i in range(n)])}


def _segment_exists(name) -> bool:
    return os.path.exists(f"/dev/shm/{name}")


def test_shm_pack_round_trip():
    arrs = {"a": np.arange(10, dtype=np.int64),
            "b": np.linspace(0, 1, 7), "empty": np.zeros(0, np.int64),
            "c": np.frombuffer(b"hello", dtype=np.uint8)}
    name = "tzrec_torch_test_pack"
    try:
        views = shm_pack.build(name, dict(arrs))
        got = shm_pack.attach(name)
        assert list(got) == list(arrs)
        for k in arrs:
            np.testing.assert_array_equal(got[k], arrs[k])
            np.testing.assert_array_equal(views[k], arrs[k])
        views["a"][0] = 42  # views of one memory, not copies
        assert got["a"][0] == 42
        assert shm_pack.segment_bytes(name) >= sum(
            a.nbytes for a in arrs.values())
    finally:
        shm_pack.unlink(name)
    assert not _segment_exists(name)


def test_shared_sampler_draws_what_an_unshared_one_draws(item_file):
    plain = sampler_mod.NegativeSampler(_Cfg(item_file))
    shared = sampler_mod.NegativeSampler(_Cfg(item_file))
    shared.prepare_shared()
    try:
        blob = pickle.dumps(shared)
        assert len(blob) < 20_000, len(blob)  # no table in the copy
        worker = pickle.loads(blob)
        worker.init()
        assert np.shares_memory(worker._ids_sorted,
                                shm_pack.attach(shared._shm_name)["ids_sorted"])
        for _ in range(2):
            cols = _cols_of([0, 1, 2, 3])
            a, b = plain.process(dict(cols)), worker.process(dict(cols))
            assert a["item_id"].equals(b["item_id"])
            assert a["item_cat"].equals(b["item_cat"])
        assert worker._attr_vals(0) == ["100", "2"]
        np.testing.assert_array_equal(
            worker._rows_of(np.array([100, 1099, 99, 5000])),
            np.array([0, 999, -1, -1]))
    finally:
        shared.close_shared()


def test_pickled_copy_attaches_without_reading_the_file(item_file,
                                                        monkeypatch):
    calls = []
    real = sampler_mod._read_table
    monkeypatch.setattr(sampler_mod, "_read_table",
                        lambda path: calls.append(path) or real(path))
    s = sampler_mod.NegativeSampler(_Cfg(item_file))
    s.prepare_shared()
    try:
        assert calls == [item_file]
        for _ in range(3):
            w = pickle.loads(pickle.dumps(s))
            assert not w._inited
            w.init()
            assert w._inited
        assert calls == [item_file]
    finally:
        s.close_shared()


@pytest.mark.parametrize("cls", ["NegativeSamplerV2", "HardNegativeSampler"])
def test_edge_tables_ride_the_segment(cls, item_file, edge_files):
    """The worker draws what the unshared sampler draws with the edge
    files moved away: its edge CSRs are the segment's."""
    edge_path, hard_path = edge_files
    make = getattr(sampler_mod, cls)
    plain = make(_V2Cfg(item_file, edge_path, hard_path))
    plain.init()
    shared = make(_V2Cfg(item_file, edge_path, hard_path))
    shared.prepare_shared()
    moved = [(p, p + ".gone") for p in edge_files]
    try:
        for a, b in moved:
            os.replace(a, b)
        worker = pickle.loads(pickle.dumps(shared))
        worker.init()
        pack = shm_pack.attach(shared._shm_name)
        keys = ["pe_items"] + (["he_items"] if cls != "NegativeSamplerV2"
                               else [])
        for k in keys:
            assert np.shares_memory(worker._tables[k], pack[k]), k
        cols = _cols_of([0, 1, 3, 7])
        a, b = plain.process(dict(cols)), worker.process(dict(cols))
        assert a["item_id"].equals(b["item_id"])
        banned = {100 + (u * 13 + j) % 400 for u in (0, 1, 3, 7)
                  for j in range(10)}
        negs = set(b["item_id"].to_pylist()[4:12])
        assert not negs & banned
        if cls == "HardNegativeSampler":
            np.testing.assert_array_equal(
                a[sampler_mod.HARD_NEG_INDICES],
                b[sampler_mod.HARD_NEG_INDICES])
            hard = set(b["item_id"].to_pylist()[12:14])
            assert hard <= {600 + j for j in range(3)}
    finally:
        for a, b in moved:
            os.replace(b, a)
        shared.close_shared()


def test_close_shared_unlinks_the_segment(item_file):
    s = sampler_mod.NegativeSampler(_Cfg(item_file))
    s.prepare_shared()
    name = s._shm_name
    assert _segment_exists(name)
    s.close_shared()
    assert not _segment_exists(name)
    assert s._shm_name is None and not s._inited
    s.close_shared()  # a second close is a no-op
    s.init()  # the tables come back from the file
    assert len(s._item_ids) == 1000


def _tdm_sampler(tree):
    text = (f'item_input_path: "{tree}/node_table.parquet" '
            f'edge_input_path: "{tree}/edge_table.parquet" '
            f'predict_edge_input_path: "{tree}/edge_table.parquet" '
            'attr_fields: "item_id" item_id_field: "item_id" '
            "layer_num_sample: [0, 1, 1, 2, 2, 3, 3]")
    return sampler_mod.TDMSampler(
        text_format.Parse(text, sampler_pb2.TDMSampler()),
        label_field="label")


def test_tdm_tree_rides_the_segment(tmp_path):
    tree = str(tmp_path / "tree")
    gen_tree.init_tree(_items(str(tmp_path / "items.parquet")), tree)
    plain, shared = _tdm_sampler(tree), _tdm_sampler(tree)
    plain.init()
    shared.prepare_shared()
    edges = os.path.join(tree, "edge_table.parquet")
    try:
        os.replace(edges, edges + ".gone")
        worker = pickle.loads(pickle.dumps(shared))
        worker.init()
        pack = shm_pack.attach(shared._shm_name)
        assert np.shares_memory(worker._tables["tree_parent"],
                                pack["tree_parent"])
        for seed in range(2):
            cols = _cols(BATCH, seed)
            a, b = plain.process(dict(cols)), worker.process(dict(cols))
            assert list(a) == list(b)
            for k in a:
                assert a[k].equals(b[k]), k
    finally:
        os.replace(edges + ".gone", edges)
        shared.close_shared()


def test_two_workers_give_the_thread_loaders_batches(tmp_path):
    """Train mode, two files (one a worker): each worker's batches are
    those of the thread loader over its shard (a fresh sampler each, as
    each worker's pickled copy starts from the same generator state); the
    segment is gone after the epoch's close."""
    root = str(tmp_path)
    gen_tree.init_tree(_items(os.path.join(root, "items.parquet")),
                       os.path.join(root, "tree"))
    data = os.path.join(root, "data")
    os.makedirs(data)
    for i in range(2):
        cols = _cols(3 * BATCH, 20 + i)
        cols["rid"] = pa.array(np.arange(3 * BATCH) + 1000 * i)
        pq.write_table(pa.table(cols), os.path.join(data, f"part-{i}.parquet"))
    text = config_text(root, os.path.join(root, "model"))

    def loader(workers, **kw):
        t = text.replace(f"  batch_size: {BATCH}",
                         f"  batch_size: {BATCH}\n  num_workers: {workers}")
        cfg = parse_pipeline_config(t)
        from torcheasyrec_tpu_torch import main as port_main

        return port_dataset.create_dataloader(
            cfg.data_config, port_main._create_features(cfg), data,
            mode="train", reserved_columns=["rid"], device="cpu", **kw)

    def batches(dl):
        it = dl()
        try:
            return {tuple(info.reserved["rid"].to_pylist()):
                    [t.numpy() for t in b.tensors()] for b, info in it}
        finally:
            it.close()

    mp = loader(2)
    assert mp.mp_workers == 2
    created = []
    real = shm_pack.build
    shm_pack.build = lambda name, arrs: created.append(name) or real(name,
                                                                   arrs)
    try:
        got = batches(mp)
    finally:
        shm_pack.build = real
    assert len(created) == 1 and not _segment_exists(created[0])
    want = {}
    for w in range(2):
        want.update(batches(loader(0, worker_id=w, num_workers=2)))
    assert len(want) == 6 and sorted(got) == sorted(want)
    for key, tensors in want.items():
        assert len(got[key]) == len(tensors)
        for a, b in zip(got[key], tensors):
            np.testing.assert_array_equal(a, b)
