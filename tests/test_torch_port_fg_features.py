"""Every feature class of the port against the JAX package's, in FG_NONE
(encoded columns) and in FG_NORMAL (feature generation from raw
columns): id features by hash, vocab list, dict and file, num_buckets,
weighted, sequence and grouped sequence inputs; raw features with
normalizers, boundaries and value_dim; combo, lookup, match, expr,
overlap, tokenize (SentencePiece, TextNormalizer, BPE where
``tokenizers`` is installed), kv-dot-product, custom, bool-mask; and the
combine feature, which the JAX package does not generate, against a
plain version of its rule. Ids bit for bit, floats within 1e-6
relative; the fg.json entries equal."""

import numpy as np
import pyarrow as pa
import pytest
from google.protobuf import text_format

from test_torch_port_fg_dag import assert_parsed_equal
from torcheasyrec_tpu.features import create_features as jax_create
from torcheasyrec_tpu.features import create_fg_json as jax_fg_json
from torcheasyrec_tpu.protos import feature_pb2 as jax_fpb
from torcheasyrec_tpu_torch.benchmark import fg_synth
from torcheasyrec_tpu_torch.features import create_features, create_fg_json
from torcheasyrec_tpu_torch.features.feature import stable_hash64
from torcheasyrec_tpu_torch.protos import feature_pb2
from torch_port_helpers import ready_jax_fg_native

FG_NONE, FG_NORMAL = 1, 2
N = 64


@pytest.fixture(autouse=True, scope="module")
def _jax_fg_native():
    """The JAX package's FG natives, loaded whole before any test here
    (``torch_port_helpers.ready_jax_fg_native``)."""
    ready_jax_fg_native()


def _both(texts, mode):
    return (
        jax_create([text_format.Parse(t, jax_fpb.FeatureConfig())
                    for t in texts], fg_mode=mode),
        create_features([text_format.Parse(t, feature_pb2.FeatureConfig())
                         for t in texts], fg_mode=mode))


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("fg_files")
    stops = d / "stops.txt"
    stops.write_text("!\n?\n")
    return {"vocab": fg_synth.write_city_vocab(str(d / "city.txt")),
            "spm": fg_synth.write_spm_model(str(d / "s.model")),
            "stops": str(stops)}


def _synth_texts(files):
    """The feature configs of the every-kind MultiTowerDIN."""
    from torcheasyrec_tpu_torch.utils.config_util import parse_pipeline_config

    fg_synth.register_fg_ops()
    from torcheasyrec_tpu.features.other_features import register_custom_op

    register_custom_op(fg_synth.CUSTOM_OP, fg_synth._len_mod)
    cfg = parse_pipeline_config(fg_synth.fg_din_config_text(
        "t", "e", "m", files["vocab"], files["spm"], N, with_combine=False))
    return [text_format.MessageToString(c) for c in cfg.feature_configs]


def test_every_kind_fg_normal_matches_jax(files):
    jfeats, feats = _both(_synth_texts(files), FG_NORMAL)
    kinds = {type(f).__name__ for f in feats}
    assert kinds == {"IdFeature", "RawFeature", "ComboFeature",
                     "LookupFeature", "MatchFeature", "ExprFeature",
                     "OverlapFeature", "KvDotProduct", "BoolMaskFeature",
                     "TokenizeFeature", "CustomFeature"}
    for seed in (1, 2):
        cols = fg_synth.fg_raw_cols(300, seed)
        for jf, f in zip(jfeats, feats):
            assert f.inputs == jf.inputs, f.name
            assert f.is_user_side == jf.is_user_side, f.name
            if f.is_sparse:
                assert f.num_embeddings == jf.num_embeddings, f.name
            assert_parsed_equal(f.parse(cols, True), jf.parse(cols, True),
                                f.name)
    assert create_fg_json(feats) == jax_fg_json(jfeats)


def _encoded_col(f, rng):
    """An encoded column for ``f``: ids below its table for a sparse
    feature (a string of multi-values for some), floats otherwise."""
    if f.is_sequence:
        return pa.array([";".join(map(str, rng.integers(0, 9, k)))
                         for k in rng.integers(0, 4, N)])
    if f.is_sparse:
        n = f.num_embeddings
        if f.is_weighted:
            return pa.array([f"{rng.integers(0, n)}:0.5\x03{rng.integers(0, n)}"
                             f":1.5" for _ in range(N)])
        return pa.array(rng.integers(0, n + 3, N))  # past the table: wrapped
    dim = max(f.value_dim, 1)
    if dim == 1:
        return pa.array(rng.normal(size=N).astype(np.float32))
    return pa.array(["\x03".join(f"{x:.3f}" for x in row)
                     for row in rng.normal(size=(N, dim))])


def test_every_kind_fg_none_matches_jax(files):
    texts = _synth_texts(files) + [
        """combine_feature { feature_name: 'cmb' hash_bucket_size: 40
           expression: ['feature:cate', 'feature:age_b'] embedding_dim: 4 }"""]
    jfeats, feats = _both(texts, FG_NONE)
    rng = np.random.default_rng(3)
    cols = {f.name: _encoded_col(f, rng) for f in feats}
    for jf, f in zip(jfeats, feats):
        assert f.inputs == jf.inputs == [f.name]
        assert_parsed_equal(f.parse(cols), jf.parse(cols, False), f.name)


ID_CASES = {
    "hash_multi": ("id_feature { feature_name: 'f' expression: 'item:x' "
                   "hash_bucket_size: 1000 separator: ',' embedding_dim: 4 }",
                   ["a,b,,c", None, "", "新疆", "x" * 300, ",", "a"]),
    "hash_default": ("id_feature { feature_name: 'f' expression: 'item:x' "
                     "hash_bucket_size: 97 default_value: 'dflt' "
                     "embedding_dim: 4 }", ["a", None, "", "b\x1dc"]),
    "num_buckets_str": ("id_feature { feature_name: 'f' expression: 'item:x'"
                        " num_buckets: 10 embedding_dim: 4 }",
                        ["3", "12", None, "0"]),
    "num_buckets_int": ("id_feature { feature_name: 'f' expression: 'item:x'"
                        " num_buckets: 10 embedding_dim: 4 }",
                        [3, 12, None, -2]),
    "hash_int": ("id_feature { feature_name: 'f' expression: 'item:x' "
                 "hash_bucket_size: 1000 embedding_dim: 4 }",
                 [3, 12, None, -(1 << 40)]),
    "hash_int_default": ("id_feature { feature_name: 'f' expression: "
                         "'item:x' hash_bucket_size: 1000 default_value: '7'"
                         " embedding_dim: 4 }", [3, None, 5]),
    "hash_float": ("id_feature { feature_name: 'f' expression: 'item:x' "
                   "hash_bucket_size: 1000 default_value: 'z' "
                   "embedding_dim: 4 }", [1.5, None, 2.0]),
    "weighted": ("id_feature { feature_name: 'f' expression: 'item:x' "
                 "hash_bucket_size: 1000 weighted: true embedding_dim: 4 }",
                 ["a:0.5\x1db:2", None, "c", "d:1e-3"]),
    "vocab_dict_dbv": ("id_feature { feature_name: 'f' expression: 'item:x'"
                       " default_bucketize_value: 6 embedding_dim: 4 "
                       "vocab_dict { key: 'a' value: 2 } "
                       "vocab_dict { key: 'b' value: 5 } }",
                       ["a", "b", "c", None, ""]),
    "sequence_hash": ("sequence_id_feature { feature_name: 'f' "
                      "expression: 'user:x' hash_bucket_size: 500 "
                      "embedding_dim: 4 sequence_length: 5 }",
                      ["a;b;c", None, "", ";;", "a\x1db;c", "é;中"]),
    "sequence_vocab": ("sequence_id_feature { feature_name: 'f' "
                       "expression: 'user:x' vocab_list: ['a', 'b'] "
                       "embedding_dim: 4 sequence_length: 5 }",
                       ["a;b;zz", None, "", "b"]),
    "sequence_two_char_delim": (
        "sequence_id_feature { feature_name: 'f' expression: 'user:x' "
        "hash_bucket_size: 500 embedding_dim: 4 sequence_length: 5 "
        "sequence_delim: '||' }", ["a||b", None, "c"]),
    "raw_zscore": ("raw_feature { feature_name: 'f' expression: 'item:x' "
                   "normalizer: 'method=zscore,mean=2,standard_deviation=3' }",
                   ["1.5", None, "", "9"]),
    "raw_minmax_num": ("raw_feature { feature_name: 'f' expression: 'item:x'"
                       " normalizer: 'method=minmax,min=1,max=5' }",
                       [1.0, 3.0, None]),
    "raw_log10_bounds": ("raw_feature { feature_name: 'f' expression: "
                         "'item:x' normalizer: 'method=log10' "
                         "boundaries: [0, 1, 2] embedding_dim: 4 }",
                         ["0.5", "10", "1000", None]),
    "raw_sequence": ("sequence_raw_feature { feature_name: 'f' "
                     "expression: 'user:x' sequence_length: 4 }",
                     ["1;2;3", None, "4.5"]),
    "raw_sequence_bounds": ("sequence_raw_feature { feature_name: 'f' "
                            "expression: 'user:x' sequence_length: 4 "
                            "boundaries: [1, 3] embedding_dim: 4 }",
                            ["1;2;3", None, "4.5"]),
}


@pytest.mark.parametrize("case", sorted(ID_CASES))
def test_id_and_raw_inputs_match_jax(case):
    text, values = ID_CASES[case]
    (jf,), (f,) = _both([text], FG_NORMAL)
    data = {"x": pa.array(values)}
    assert_parsed_equal(f.parse(data, True), jf.parse(data, True), case)


def test_grouped_sequence_sub_features_match_jax():
    text = """sequence_feature { sequence_name: 'click' sequence_length: 4
      sequence_delim: '|'
      features { id_feature { feature_name: 'iid' expression: 'item:iid'
                 hash_bucket_size: 100 embedding_dim: 4 } }
      features { raw_feature { feature_name: 'p' expression: 'item:p' } }
      features { combo_feature { feature_name: 'x' hash_bucket_size: 50
                 expression: ['user:u', 'item:iid'] embedding_dim: 4 } } }"""
    jfeats, feats = _both([text], FG_NORMAL)
    assert [f.inputs for f in feats] == [f.inputs for f in jfeats] == [
        ["click__iid"], ["click__p"], ["u", "click__iid"]]
    data = {"click__iid": pa.array(["a|b|c", None, "d"]),
            "click__p": pa.array(["1|2|3", "", "4"]),
            "u": pa.array(["u1", "u2", None])}
    for jf, f in zip(jfeats, feats[:2]):
        assert_parsed_equal(f.parse(data), jf.parse(data, False), f.name)
    assert create_fg_json(feats) == jax_fg_json(jfeats)


def test_tokenize_spm_and_text_normalizer_match_jax(files):
    text = (f"tokenize_feature {{ feature_name: 'tok' expression: 'item:t' "
            f"vocab_file: '{files['spm']}' tokenizer_type: 'sentencepiece' "
            f"embedding_dim: 4 text_normalizer {{ stop_char_file: "
            f"'{files['stops']}' norm_options: [TEXT_UPPER2LOWER, "
            f"TEXT_SBC2DBC, TEXT_FILTER] }} }}")
    (jf,), (f,) = _both([text], FG_NORMAL)
    assert f.num_embeddings == jf.num_embeddings
    data = {"t": pa.array(["the Cat!", "ＲＥＤ　bag?", None, "", "zzq new"])}
    got = f.parse(data)
    assert_parsed_equal(got, jf.parse(data, False), "tok")
    assert got.lengths.tolist()[2:4] == [0, 0]


def test_tokenize_that_fails_to_load_raises(tmp_path):
    bad = tmp_path / "bad.model"
    bad.write_bytes(b"\x0f")  # a key of wire type 7: no ModelProto
    text = (f"tokenize_feature {{ feature_name: 'tok' expression: 'item:t' "
            f"vocab_file: '{bad}' tokenizer_type: 'sentencepiece' "
            "embedding_dim: 4 }")
    (f,) = _both([text], FG_NORMAL)[1]
    with pytest.raises(ValueError):
        f.parse({"t": pa.array(["a"])})


def test_tokenize_bpe_matches_jax(tmp_path):
    pytest.importorskip("tokenizers")
    from tokenizers import Tokenizer, models, pre_tokenizers, trainers

    tok = Tokenizer(models.BPE(unk_token="[UNK]"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    tok.train_from_iterator(
        ["the quick brown fox jumps over the lazy dog"] * 4,
        trainers.BpeTrainer(vocab_size=60, special_tokens=["[UNK]"]))
    path = str(tmp_path / "tokenizer.json")
    tok.save(path)
    text = (f"tokenize_feature {{ feature_name: 'tok' expression: 'item:t' "
            f"vocab_file: '{path}' embedding_dim: 4 }}")
    (jf,), (f,) = _both([text], FG_NORMAL)
    data = {"t": pa.array(["the quick fox", None, "lazy dogs"])}
    assert f.num_embeddings == jf.num_embeddings
    assert_parsed_equal(f.parse(data), jf.parse(data, False), "tok")


def test_expr_namespace_has_no_builtins():
    text = """expr_feature { feature_name: 'e' variables: ['item:a']
              expression: "__import__('os')" }"""
    (jf,), (f,) = _both([text], FG_NORMAL)
    data = {"a": pa.array([1.0, 2.0])}
    for feat in (jf, f):
        with pytest.raises(NameError):
            feat.parse(data, False) if feat is jf else feat.parse(data)


def test_stable_hash64_is_the_jax_hash():
    from torcheasyrec_tpu.features.feature import stable_hash64 as jax_hash

    toks = np.asarray(["", "a", "新疆", "x" * 300], dtype=object)
    np.testing.assert_array_equal(stable_hash64(toks), jax_hash(toks))


def _plain_combine(parsed, names, bucket):
    """The combine rule, written out: per row the upstream ids (as decimal
    strings) one after the other, hashed."""
    rows = None
    for name in names:
        d = parsed[name]
        starts = np.concatenate([[0], np.cumsum(d.lengths)])
        up = [[str(v) for v in d.values[starts[i]:starts[i + 1]]]
              for i in range(len(d.lengths))]
        rows = up if rows is None else [a + b for a, b in zip(rows, up)]
    toks = [t for r in rows for t in r]
    from torcheasyrec_tpu import fg as jax_fg

    return jax_fg.hash_strings_mod(toks, bucket), [len(r) for r in rows]


def test_combine_feature_through_the_parser(files):
    from torcheasyrec_tpu_torch.datasets.data_parser import DataParser

    texts = [
        "id_feature { feature_name: 'cate' expression: 'item:cate' "
        "hash_bucket_size: 50 embedding_dim: 4 }",
        "raw_feature { feature_name: 'age_b' expression: 'user:age' "
        "boundaries: [18, 25, 35] embedding_dim: 4 }",
        "raw_feature { feature_name: 'price' expression: 'item:price' }",
        "raw_feature { feature_name: 'p2' expression: 'item:price_num' }",
        "combine_feature { feature_name: 'cmb' hash_bucket_size: 300 "
        "expression: ['feature:cate', 'feature:age_b'] embedding_dim: 4 }",
        "combine_feature { feature_name: 'cd' combiner: 'sum' "
        "expression: ['feature:price', 'feature:p2'] }",
    ]
    jfeats, feats = _both(texts[:4], FG_NORMAL)
    _, feats = _both(texts, FG_NORMAL)
    cols = fg_synth.fg_raw_cols(200, 4)
    parser = DataParser(feats)
    assert feats[4].inputs == [] and feats[4].upstream == ["cate", "age_b"]
    out = parser.parse(cols)
    ref = {f.name: jf.parse(cols, False) for jf, f in zip(jfeats, feats)}
    ids, lengths = _plain_combine(ref, ["cate", "age_b"], 300)
    np.testing.assert_array_equal(out["cmb"].values, ids)
    np.testing.assert_array_equal(out["cmb"].lengths, lengths)
    np.testing.assert_array_equal(
        out["cd"].values, ref["price"].values + ref["p2"].values)
