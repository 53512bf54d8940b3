"""The port's single-buffer batch copy (datasets/pack.py) against the
JAX package's (CPU).

For the JAX test's mixed batch and a parsed criteo_synth batch, with and
without ``dense_bf16``: every leaf's wire kind equals the JAX
``pack_batch``'s (leaves matched by field, not by flatten order), and
every unpacked leaf equals the JAX ``unpack_batch``'s (ints bit for bit,
bf16 dense leaves as fp32 of the same rounded values). Envelopes only
widen; an int64 leaf whose values leave int32 is never narrowed; every
section is aligned to its item size, widest first; ``unify_spec`` widens
disagreeing integer kinds and refuses disagreeing float kinds; a copied
batch's host batch stays unbuilt until it is read, and a worker's
hand-over unpacks to the batch it packed; the CPU loader's batches
(packed and unpacked on the host) equal the parsed ones."""

import dataclasses

import jax
import ml_dtypes
import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch
import torch.utils._pytree as pytree

from torch_port_helpers import zoo_cols, zoo_config_text
from torcheasyrec_tpu.datasets import pack as jax_pack
from torcheasyrec_tpu.datasets import utils as jax_utils
from torcheasyrec_tpu_torch.datasets import pack
from torcheasyrec_tpu_torch.datasets import utils as port_utils


@pytest.fixture(autouse=True)
def fresh_envelopes(monkeypatch):
    monkeypatch.setattr(jax_pack, "_ENVELOPES", {})
    monkeypatch.setattr(pack, "_ENVELOPES", {})


def _mixed(u):
    """The JAX test's mixed batch in package ``u``'s classes (numpy leaves
    for the JAX package, tensors over the same arrays for the port)."""
    conv = np.asarray if u is jax_utils else torch.from_numpy
    return u.Batch(
        dense_features={"price": u.DenseField(
            values=conv(np.array([[1.5], [2.3]], np.float32)))},
        sparse_features={
            "cat": u.SparseField(values=conv(np.array([[3], [-1]], np.int32))),
            "big": u.SparseField(values=conv(np.array([[3], [40000]],
                                                      np.int32))),
            "tags": u.SparseField(
                values=conv(np.array([7, 8, 9, -1], np.int32)),
                lengths=conv(np.array([2, 1], np.int32)),
                weights=conv(np.array([0.1, 0.2, 0.3, 0.0], np.float32))),
        },
        sequence_sparse_features={"clicks": u.SparseField(
            values=conv(np.array([[1, 2, -1], [4, -1, -1]], np.int32)),
            lengths=conv(np.array([2, 1], np.int32)))},
        sequence_dense_features={"ts": u.SequenceDenseField(
            values=conv(np.array([[[0.1], [1.7], [0]], [[2.9], [0], [0]]],
                                 np.float32)),
            lengths=conv(np.array([2, 1], np.int32)))},
        labels={"label": conv(np.array([1.0, 0.0], np.float32))},
        sample_weights={"w": conv(np.array([1.0, 2.0], np.float32))},
    )


def _criteo(u):
    """A parsed criteo_synth batch (the zoo's narrowed DBMTL features)."""
    from torcheasyrec_tpu_torch.utils.config_util import (
        parse_pipeline_config,
    )

    cfg = parse_pipeline_config(zoo_config_text("dbmtl", 32))
    cols = zoo_cols(32, seed=5)
    labels = list(cfg.data_config.label_fields)
    if u is jax_utils:
        from google.protobuf import text_format

        from torcheasyrec_tpu.datasets.data_parser import DataParser
        from torcheasyrec_tpu.features.feature import create_features
        from torcheasyrec_tpu.protos import pipeline_pb2

        jcfg = text_format.Parse(zoo_config_text("dbmtl", 32),
                                 pipeline_pb2.EasyRecConfig())
        return DataParser(create_features(
            list(jcfg.feature_configs), fg_mode=jcfg.data_config.fg_mode),
            labels=labels).parse_to_batch(cols)
    from torcheasyrec_tpu_torch.datasets.data_parser import DataParser
    from torcheasyrec_tpu_torch.features.feature import create_features

    return DataParser(create_features(
        list(cfg.feature_configs), fg_mode=cfg.data_config.fg_mode),
        labels=labels).parse_to_batch(cols)


def _named(batch):
    """{"<attribute>.<name>.<field>": leaf} of either package's batch."""
    out = {}
    for f in dataclasses.fields(batch):
        v = getattr(batch, f.name)
        if not isinstance(v, dict):
            continue
        for name, x in v.items():
            if dataclasses.is_dataclass(x):
                for g in dataclasses.fields(x):
                    leaf = getattr(x, g.name)
                    if leaf is not None:
                        out[f"{f.name}.{name}.{g.name}"] = leaf
            else:
                out[f"{f.name}.{name}"] = x
    return out


def _kinds(batch, packed, leaves):
    """{leaf name: wire kind} (``leaves``: the package's flatten)."""
    index = {id(x): i for i, x in enumerate(leaves(batch))}
    metas = packed.spec[1]
    return {k: metas[index[id(x)]][0] for k, x in _named(batch).items()}


@pytest.mark.parametrize("dense_bf16", [False, True])
@pytest.mark.parametrize("which", ["mixed", "criteo"])
def test_wire_kinds_and_unpacked_leaves_match_jax(which, dense_bf16):
    make = _mixed if which == "mixed" else _criteo
    jb, pb = make(jax_utils), make(port_utils)
    jp = jax_pack.pack_batch(jb, dense_bf16=dense_bf16)
    pp = pack.pack_batch(pb, dense_bf16=dense_bf16)
    jk = _kinds(jb, jp, jax.tree_util.tree_leaves)
    pk = _kinds(pb, pp, pytree.tree_leaves)
    assert jk == pk
    assert pp.nbytes == jp.nbytes
    assert ("bf16" in pk.values()) == (dense_bf16 and bool(
        pb.dense_features or pb.sequence_dense_features))
    ju, pu = _named(jax_pack.unpack_batch(jp)), _named(pack.unpack_batch(pp))
    assert set(ju) == set(pu)
    for k, ref in ju.items():
        ref = np.asarray(ref)
        got = pu[k]
        assert got.dtype == _named(pb)[k].dtype, k
        if ref.dtype == ml_dtypes.bfloat16:
            ref = ref.astype(np.float32)
        np.testing.assert_array_equal(got.numpy(), ref, err_msg=k)


def test_dense_bf16_rounds_as_jax_and_keeps_labels_exact():
    pb = _mixed(port_utils)
    u = pack.unpack_batch(pack.pack_batch(pb, dense_bf16=True))
    price = pb.dense_features["price"].values
    assert u.dense_features["price"].values.dtype == torch.float32
    assert torch.equal(u.dense_features["price"].values,
                       price.to(torch.bfloat16).float())
    assert not torch.equal(u.dense_features["price"].values, price)
    assert torch.equal(u.labels["label"], pb.labels["label"])
    assert torch.equal(u.sparse_features["tags"].weights,
                       pb.sparse_features["tags"].weights)


def test_envelopes_only_widen_and_int64_is_never_narrowed():
    def one(v, dtype=torch.int32):
        return port_utils.Batch(sparse_features={"cat": port_utils.SparseField(
            torch.tensor(v, dtype=dtype))})

    small = pack.pack_batch(one([[1], [2]]))
    assert small.spec[1][0][0] == "u8"
    wide = pack.pack_batch(one([[1], [100_000]]))
    assert wide.spec[1][0][0] == "i32"
    again = pack.pack_batch(one([[1], [2]]))
    assert again.spec == wide.spec
    assert torch.equal(pack.unpack_batch(again).sparse_features["cat"].values,
                       torch.tensor([[1], [2]], dtype=torch.int32))
    big = one([[3], [2**40 + 7]], torch.int64)
    p = pack.pack_batch(big)
    assert p.spec[1][0][0] == "i64"
    got = pack.unpack_batch(p).sparse_features["cat"].values
    assert got.dtype == torch.int64 and torch.equal(
        got, big.sparse_features["cat"].values)


def test_sections_are_aligned_widest_first():
    p = pack.pack_batch(_mixed(port_utils), dense_bf16=True)
    metas = sorted(p.spec[1], key=lambda m: m[1])
    sizes = [pack._ITEMSIZE[m[0]] for m in metas]
    assert sizes == sorted(sizes, reverse=True)
    for kind, off, _, _ in metas:
        assert off % pack._ITEMSIZE[kind] == 0


def test_unify_spec_widens_ints_and_refuses_floats():
    def batch(v):
        return port_utils.Batch(
            sparse_features={"cat": port_utils.SparseField(
                torch.tensor(v, dtype=torch.int32))},
            labels={"l": torch.tensor([1.0, 0.0])})

    state = {}
    a = pack.pack_batch(batch([[1], [2]]))
    pack._ENVELOPES.clear()  # another worker's envelopes
    b = pack.pack_batch(batch([[1], [-300]]))
    assert pack.unify_spec(a, state) is a
    u = pack.unify_spec(b, state)
    assert [m[0] for m in u.spec[1]] == ["f32", "i32"] or [
        m[0] for m in u.spec[1]] == ["i32", "f32"]
    assert torch.equal(pack.unpack_batch(u).sparse_features["cat"].values,
                       torch.tensor([[1], [-300]], dtype=torch.int32))
    assert u.wire is not b.wire and torch.equal(
        pack.unpack_batch(b).sparse_features["cat"].values,
        pack.unpack_batch(u).sparse_features["cat"].values)
    bad = pack.PackedBatch(a.wire, (a.spec[0], tuple(
        ("bf16",) + m[1:] if m[3] == "float32" else m for m in a.spec[1])))
    with pytest.raises(ValueError, match="no integer"):
        pack.unify_spec(bad, {a.spec[0]: [m[0] for m in a.spec[1]]})


def test_host_batch_stays_lazy():
    """The loader's copy keeps its host batch as a thunk over the pinned
    wire (``Batch.set_host``): built once, at the first read, and handed
    on unbuilt by ``keep_host`` (the ZCH remap's new batch)."""
    pb = _mixed(port_utils)
    wire = pack.pack_batch(pb).to_numpy()  # a loader worker's hand-over
    got = wire.from_numpy()
    calls = []
    dev = pack.unpack_batch(got)
    dev.set_host(lambda: calls.append(1) or pack.unpack_batch(got))
    remapped = dataclasses.replace(dev)
    remapped.keep_host(dev)
    assert not calls
    host = remapped.host
    assert calls == [1] and remapped.host is host
    assert torch.equal(host.sparse_features["big"].values,
                       pb.sparse_features["big"].values)
    assert dev.host is not host and calls == [1, 1]
    # after the loader's pin-memory thread: a tensor wire, the structure
    # still the worker's string
    pinned = pack.PackedBatch(torch.from_numpy(wire.wire), wire.spec)
    assert isinstance(wire.spec[0], str)
    assert pinned.from_numpy().spec == got.spec
    assert torch.equal(pack.unpack_batch(pinned.from_numpy()).sparse_features[
        "big"].values, pb.sparse_features["big"].values)


def test_cpu_loader_packs_as_it_copies(tmp_path):
    """The thread loader, which packs every batch and unpacks it on the
    host, gives the batches its dataset parses (their dense features
    rounded to bf16 with ``dense_bf16``), of the same dtypes."""
    from torcheasyrec_tpu_torch.datasets.dataset import create_dataloader
    from torcheasyrec_tpu_torch.main import _create_features
    from torcheasyrec_tpu_torch.utils.config_util import (
        parse_pipeline_config,
    )

    pq.write_table(pa.table(zoo_cols(96, seed=2)),
                   str(tmp_path / "part.parquet"))
    cfg = parse_pipeline_config(zoo_config_text("dbmtl", 32))
    feats = _create_features(cfg)

    def loader(**kw):
        return create_dataloader(cfg.data_config, feats,
                                 str(tmp_path / "part.parquet"), mode="eval",
                                 **kw)

    def batches(**kw):
        it = loader(**kw)()
        try:
            return [b for b, _ in it]
        finally:
            it.close()

    plain = [b for b, _ in loader().dataset]
    for bf16 in (False, True):
        got = batches(dense_bf16=bf16)
        assert len(got) == len(plain) == 3
        for a, b in zip(got, plain):
            na, nb = _named(a), _named(b)
            assert set(na) == set(nb)
            for k in nb:
                ref = nb[k]
                if bf16 and k.startswith("dense_features"):
                    ref = ref.to(torch.bfloat16).float()
                assert na[k].dtype == ref.dtype and torch.equal(na[k], ref), k
