"""The port's native FG DAG (``fg/dag.py``) and its features' Python
parses against the JAX package's ``FgDag`` and ``feature.parse``: the
feature list and column probes of the JAX DAG tests, randomized match,
kv and overlap columns, vocab tasks, hand-backs, and the whole parser on
a raw table (the JAX ``DataParser`` and the port's give the same batch,
bit for bit). Ids must be equal; float values within 1e-6 relative."""

import numpy as np
import pyarrow as pa
import pytest
from google.protobuf import text_format

import test_fg_dag as jax_dag_tests
from torcheasyrec_tpu.features import create_features as jax_create
from torcheasyrec_tpu.fg.dag import FgDag as JaxDag
from torcheasyrec_tpu.protos import feature_pb2 as jax_fpb
from torcheasyrec_tpu_torch.benchmark import fg_synth
from torcheasyrec_tpu_torch.features import create_features
from torcheasyrec_tpu_torch.fg.dag import FgDag
from torcheasyrec_tpu_torch.protos import feature_pb2
from torch_port_helpers import ready_jax_fg_native

FG_NORMAL = 2


@pytest.fixture(autouse=True, scope="module")
def _jax_fg_native():
    """The JAX package's FG natives, loaded whole before any test here
    (``torch_port_helpers.ready_jax_fg_native``)."""
    ready_jax_fg_native()


def _both(texts, **kw):
    """(JAX features, port features) of the same config texts."""
    return (
        jax_create([text_format.Parse(t, jax_fpb.FeatureConfig())
                    for t in texts], fg_mode=FG_NORMAL, **kw),
        create_features([text_format.Parse(t, feature_pb2.FeatureConfig())
                         for t in texts], fg_mode=FG_NORMAL, **kw))


def assert_parsed_equal(got, ref, name):
    assert type(got).__name__ == type(ref).__name__, name
    if type(ref).__name__ in ("SparseData", "SequenceSparseData"):
        np.testing.assert_array_equal(got.values, ref.values, err_msg=name)
        np.testing.assert_array_equal(got.lengths, ref.lengths, err_msg=name)
        assert got.values.dtype == np.int64, name
    else:
        assert got.values.shape == ref.values.shape, name
        np.testing.assert_allclose(got.values, ref.values, rtol=1e-6,
                                   atol=1e-7, err_msg=name)
    for k in ("weights", "seq_lengths"):
        if getattr(ref, k, None) is not None:
            np.testing.assert_array_equal(getattr(got, k), getattr(ref, k),
                                          err_msg=f"{name}.{k}")


def _check(texts, data, handled=None):
    jfeats, feats = _both(texts)
    dag = FgDag(feats)
    if handled is not None:
        assert {f.name for f in dag.native} == handled
        assert {f.name for f in JaxDag(jfeats)._native} == handled
    native = dag.parse(data)
    jnative = JaxDag(jfeats).parse(data, False)
    for jf, f in zip(jfeats, feats):
        ref = jf.parse(data, False)
        py = f.parse(data)
        assert_parsed_equal(py, ref, f"{f.name} (Python)")
        if f.name in native:
            # the port's DAG equals its Python parse bit for bit
            assert_parsed_equal(native[f.name], py, f"{f.name} (DAG)")
            np.testing.assert_array_equal(native[f.name].values, py.values)
            assert_parsed_equal(native[f.name], jnative[f.name],
                                f"{f.name} (JAX DAG)")
    return dag


def test_dag_matches_jax_on_the_probe_columns():
    dag = _check(jax_dag_tests.FEATURES, jax_dag_tests._data(),
                 handled={"cat", "tags", "price", "ctr", "cat_x_cty", "kv",
                          "m", "ov", "ovb", "kvd", "kvdb"})
    # "zz" in a kv value is outside plain decimal notation: handed back
    assert dag.handbacks == {"kvd": 1, "kvdb": 1}


def _rand_val(rng):
    r = rng.random()
    if r < 0.2:
        return ""
    if r < 0.35:
        return "x9z"
    return f"{rng.normal():.4g}"


@pytest.mark.parametrize("seed", [0, 1])
def test_dag_randomized_match_kv_overlap(seed):
    rng = np.random.default_rng(seed)
    n = 300
    keys, pks = ["a", "bb", "ccc", "d"], ["p1", "p2", "p3"]
    toks = ["a", "bb", "ccc", "d", "ee"]

    def kv_row():
        return None if rng.random() < 0.1 else "\x1d".join(
            f"{keys[rng.integers(0, 4)]}:{_rand_val(rng)}"
            for _ in range(rng.integers(0, 5)))

    def nested_row():
        if rng.random() < 0.1:
            return None
        return "|".join(
            f"{pks[rng.integers(0, 3)]}^" + ",".join(
                f"{keys[rng.integers(0, 4)]}:{_rand_val(rng)}"
                for _ in range(rng.integers(0, 4)))
            for _ in range(rng.integers(0, 4)))

    def tok_row():
        return None if rng.random() < 0.1 else "\x1d".join(
            toks[rng.integers(0, 5)] for _ in range(rng.integers(0, 6)))

    data = {
        "nested": pa.array([nested_row() for _ in range(n)]),
        "pk": pa.array([pks[rng.integers(0, 3)] for _ in range(n)]),
        "sk": pa.array([keys[rng.integers(0, 4)] for _ in range(n)]),
        "kv_map": pa.array([kv_row() for _ in range(n)]),
        "kv_map2": pa.array([kv_row() for _ in range(n)]),
        "kv_key": pa.array([keys[rng.integers(0, 4)] for _ in range(n)]),
        "query": pa.array([tok_row() for _ in range(n)]),
        "title": pa.array([tok_row() for _ in range(n)]),
    }
    texts = [
        """match_feature { feature_name: 'm' nested_map: 'user:nested'
           pkey: 'item:pk' skey: 'item:sk' }""",
        """lookup_feature { feature_name: 'kv'
           expression: ['item:kv_map', 'user:kv_key'] }""",
        """overlap_feature { feature_name: 'ov' method: 'title_common_ratio'
           expression: ['user:query', 'item:title'] }""",
        """overlap_feature { feature_name: 'ove' method: 'is_equal'
           expression: ['user:query', 'item:title'] }""",
        """overlap_feature { feature_name: 'ovq' method: 'query_common_ratio'
           expression: ['user:query', 'item:title']
           boundaries: [0.25, 0.5, 0.75] embedding_dim: 4 }""",
        """kv_dot_product { feature_name: 'kvd'
           expression: ['user:kv_map', 'item:kv_map2'] }""",
    ]
    _check(texts, data, handled={"m", "kv", "ov", "ove", "ovq", "kvd"})


VOCAB_SPECS = [
    """id_feature { feature_name: 'v1' expression: 'item:s'
       default_value: 'bb' embedding_dim: 4
       vocab_list: ['aa', 'bb', 'zz', 'é中'] }""",
    """id_feature { feature_name: 'v2' expression: 'item:s'
       default_bucketize_value: 9 embedding_dim: 4
       vocab_list: ['aa', 'bb', 'zz', 'é中'] }""",
    """id_feature { feature_name: 'v3' expression: 'item:s'
       embedding_dim: 4 vocab_dict { key: 'aa' value: 3 }
       vocab_dict { key: '' value: 5 } vocab_dict { key: 'zzz' value: 7 } }""",
    """id_feature { feature_name: 'v4' expression: 'item:i'
       embedding_dim: 4 default_value: '7' vocab_list: ['7', '42', '100'] }""",
]


def test_vocab_tasks_match_jax_and_nulls_route_to_python():
    data = {"s": pa.array(["aa", "zz", "", "é中", "missing", None, "a",
                           "zzz", "bb"]),
            "i": pa.array([7, 42, 101, None, 0, 42, 7, 9, 100])}
    _check(VOCAB_SPECS, data, handled={"v1", "v2", "v3", "v4"})
    # nulls without a default_value: the Python path drops the row, so
    # this batch goes to the Python parse by rule, not by a hand-back
    text = """id_feature { feature_name: 'v5' expression: 'item:s'
              embedding_dim: 4 vocab_list: ['aa', 'bb'] }"""
    dag = _check([text], data, handled={"v5"})
    assert dag.routed == {"v5": 1} and dag.handbacks == {}
    assert (FgDag(_both([text])[1]).parse(data)["v5"].lengths == 0).any()


def test_column_types_the_tasks_do_not_take_route_to_python():
    text = """id_feature { feature_name: 'h' expression: 'item:l'
              hash_bucket_size: 100 embedding_dim: 4 }"""
    jfeats, feats = _both([text])
    dag = FgDag(feats)
    data = {"l": pa.array([[1, 2], None, [3]])}
    assert not dag._columns_ok(feats[0], data)
    assert_parsed_equal(dag.parse(data)["h"], jfeats[0].parse(data, False),
                        "h")
    assert dag.routed == {"h": 1}
    ok = {"l": pa.array(["1", "2"])}
    assert dag._columns_ok(feats[0], ok)
    np.testing.assert_array_equal(dag.parse(ok)["h"].values,
                                  jfeats[0].parse(ok, False).values)


def test_long_combo_key_is_handed_back():
    text = """combo_feature { feature_name: 'c'
              expression: ['user:a', 'item:b'] hash_bucket_size: 97
              embedding_dim: 4 }"""
    data = {"a": pa.array(["x" * 5000, "p", None]),
            "b": pa.array(["y", "q", "r"])}
    dag = _check([text], data, handled={"c"})
    assert dag.handbacks == {"c": 1}


def _assert_batches(b, jb, exact_dense: bool) -> None:
    for kind in ("sparse_features", "dense_features",
                 "sequence_sparse_features", "labels"):
        jd, d = getattr(jb, kind), getattr(b, kind)
        assert set(jd) == set(d), kind
        for name in d:
            pairs = ([(field, getattr(jd[name], field, None),
                       getattr(d[name], field, None))
                      for field in ("values", "lengths", "weights")]
                     if kind != "labels" else [("", jd[name], d[name])])
            for field, r, g in pairs:
                if r is None:
                    assert g is None, (name, field)
                    continue
                if kind == "dense_features" and not exact_dense:
                    np.testing.assert_allclose(
                        g.numpy(), np.asarray(r), rtol=1e-6, atol=1e-7,
                        err_msg=f"{name}.{field}")
                else:
                    np.testing.assert_array_equal(
                        g.numpy(), np.asarray(r), err_msg=f"{name}.{field}")


@pytest.mark.parametrize("threads", [1, 4])
def test_parsers_give_the_jax_batch_on_a_raw_table(tmp_path, threads):
    """The JAX DataParser and the port's turn the raw table of every FG
    kind into the same batch: bit for bit against the JAX parser's
    Python parses; against the JAX parser with its DAG, ids bit for bit
    and dense values within 1e-6 (the JAX DAG takes log10 of the double,
    the Python parses of the float32)."""
    from torcheasyrec_tpu.datasets.data_parser import DataParser as JaxParser
    from torcheasyrec_tpu.features.other_features import (
        register_custom_op as jax_register,
    )
    from torcheasyrec_tpu_torch.datasets.data_parser import DataParser
    from torcheasyrec_tpu_torch.utils.config_util import parse_pipeline_config

    fg_synth.register_fg_ops()
    jax_register(fg_synth.CUSTOM_OP, fg_synth._len_mod)
    text = fg_synth.fg_din_config_text(
        "t", "e", "m", fg_synth.write_city_vocab(str(tmp_path / "v.txt")),
        fg_synth.write_spm_model(str(tmp_path / "s.model")), 64,
        with_combine=False)
    cfg = parse_pipeline_config(text)
    fc = [text_format.MessageToString(c) for c in cfg.feature_configs]
    jfeats = jax_create([text_format.Parse(t, jax_fpb.FeatureConfig())
                         for t in fc], fg_mode=FG_NORMAL)
    feats = create_features(list(cfg.feature_configs), fg_mode=FG_NORMAL)
    jparser = JaxParser(jfeats, labels=["label"], fg_threads=threads)
    jpython = JaxParser(jfeats, labels=["label"])
    jpython._fg_dag = None
    parser = DataParser(feats, labels=["label"], fg_threads=threads)
    assert {f.name for f in parser.fg_dag.native} == {
        f.name for f in jparser._fg_dag._native}
    for seed in (5, 6):
        cols = fg_synth.fg_raw_cols(500, seed)
        b = parser.parse_to_batch(cols)
        _assert_batches(b, jpython.parse_to_batch(cols), exact_dense=True)
        _assert_batches(b, jparser.parse_to_batch(cols), exact_dense=False)
    # city's nulls (no default_value) go to the Python parse by rule
    assert parser.fg_dag.handbacks == {}
    assert parser.fg_dag.routed == {"city": 2}
