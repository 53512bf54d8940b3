"""Raw-column data and a MultiTowerDIN config with one feature of every
FG kind, for feature generation from raw columns (``fg_mode:
FG_NORMAL``).

``fg_raw_cols`` draws a table of raw log columns from a seed (strings,
id:weight lists, "k:v" maps, nested maps, sequences, numbers as strings,
text), with a click label planted on a few of them so that a model
learns; ``fg_din_config_text`` writes the config that reads them:

- ids by hash (``uid``), ``vocab_list`` (``cate``), ``vocab_dict``
  (``brand``), ``vocab_file`` (``city``), ``num_buckets`` (``item_nb``)
  and weighted multi-value tags (``tags_w``);
- the click history (``click_seq``, hashed on the sequence split-hash
  path) with its target item (``tgt_item``), one table ``item_emb``;
- raw features with log10 (``price``), with boundaries (``age_b``) and
  of ``value_dim`` 4 (``vec4``);
- combo, lookup, match, expr, overlap (a ratio, and bucketized),
  kv-dot-product, bool-mask, custom (the op ``register_fg_ops``
  registers), tokenize (a SentencePiece model, ``write_spm_model``) and
  combine features.

The widths are assumed (no published config of this shape exists); the
caller sets them. ``uid``, ``city``, ``tags_w``, ``age_b`` and
``click_seq`` are user-side: INPUT_TILE parses them once a request.
"""

import struct
from typing import Dict

import numpy as np
import pyarrow as pa

CATES = [f"c{i}" for i in range(12)]
BRANDS = {f"b{i}": i + 2 for i in range(20)}
CITIES = [f"city_{i}" for i in range(30)]
TAGS = [f"t{i}" for i in range(40)]
WORDS = ["red", "blue", "shoe", "bag", "the", "cat", "new", "sale"]
N_USERS = 2000
N_ITEMS = 1500
SEQ_LEN = 20
# past the embedding engine's dense lane (32 768 rows): the user table
# takes the sorted row write (kernel #3)
UID_BUCKETS = 100_000
CUSTOM_OP = "fg_synth_len_mod"
CUSTOM_BUCKETS = 16


# --- a SentencePiece model, written field by field ---------------------

def _varint(x: int) -> bytes:
    out = b""
    while True:
        b = x & 0x7F
        x >>= 7
        out += bytes([b | (0x80 if x else 0)])
        if not x:
            return out


def _ld(fn: int, payload: bytes) -> bytes:
    return bytes([(fn << 3) | 2]) + _varint(len(payload)) + payload


def _piece(text: str, score: float, ptype: int = 1) -> bytes:
    body = _ld(1, text.encode())
    body += bytes([(2 << 3) | 5]) + struct.pack("<f", score)
    body += bytes([(3 << 3) | 0]) + _varint(ptype)
    return _ld(1, body)


def write_spm_model(path: str) -> str:
    """A unigram SentencePiece ModelProto: <unk>, the word pieces of
    ``WORDS`` (▁-prefixed), and single characters, so that text of
    ``WORDS`` segments into words and anything else into characters."""
    pieces = [_piece("<unk>", 0.0, ptype=2), _piece("▁", -4.0)]
    pieces += [_piece("▁" + w, -1.0 - 0.1 * i)
               for i, w in enumerate(WORDS)]
    pieces += [_piece(ch, -3.0) for ch in "abcdefghijklmnopqrstuvwxyz"]
    buf = b"".join(pieces) + _ld(2, _varint(40 << 3) + _varint(0))
    with open(path, "wb") as f:
        f.write(buf)
    return path


def write_city_vocab(path: str) -> str:
    """The ``vocab_file`` of ``city``: "token index" lines (index from 2;
    1 is the OOV id)."""
    with open(path, "w") as f:
        f.writelines(f"{c} {i + 2}\n" for i, c in enumerate(CITIES))
    return path


def _len_mod(columns, params):
    """The custom op: the byte length of each ``title`` cell mod
    ``CUSTOM_BUCKETS`` (one id a row; a null cell has none)."""
    col = next(iter(columns.values())).to_pylist()
    vals = [len(s.encode()) % CUSTOM_BUCKETS for s in col if s is not None]
    return vals, [0 if s is None else 1 for s in col]


def register_fg_ops() -> None:
    """Register the custom feature's op (``CUSTOM_OP``) with the port."""
    from torcheasyrec_tpu_torch.features.other_features import (
        register_custom_op,
    )

    register_custom_op(CUSTOM_OP, _len_mod)


# --- the raw table -----------------------------------------------------

def _pick(rng, items, n, p_null=0.0):
    idx = rng.integers(0, len(items), n)
    out = [items[i] for i in idx]
    if p_null:
        out = [None if m else v for v, m in zip(out, rng.random(n) < p_null)]
    return out


def fg_raw_cols(n: int, seed: int, rows_per_user: int = 1
                ) -> Dict[str, pa.Array]:
    """``n`` rows of raw columns and a ``label``. With ``rows_per_user``
    > 1, each run of that many rows shares one user's columns (a request
    of one user and several candidate items, as INPUT_TILE serves)."""
    rng = np.random.default_rng(seed)
    users = rng.integers(0, N_USERS, (n + rows_per_user - 1) // rows_per_user)
    user_of = np.repeat(users, rows_per_user)[:n]
    urng = np.random.default_rng([seed, 1])

    def per_user(values):
        # one draw a user row group, repeated over its rows
        return [values[i // rows_per_user] for i in range(n)]

    nu = len(users)
    cols: Dict[str, pa.Array] = {}
    cols["user_id"] = pa.array([f"u{u}" for u in user_of])
    cols["city"] = pa.array(per_user(
        _pick(urng, CITIES + ["city_unknown"], nu, 0.05)))
    cols["age"] = pa.array(per_user(
        [None if m else float(a) for a, m in zip(
            urng.integers(15, 70, nu), urng.random(nu) < 0.05)]))
    cols["tags_w"] = pa.array(per_user([
        "\x1d".join(f"{t}:{w:.3f}" for t, w in zip(
            _pick(urng, TAGS, k), urng.random(k) * 2))
        for k in urng.integers(0, 5, nu)]))
    seqs = [";".join(f"i{j}" for j in urng.integers(0, N_ITEMS, k))
            for k in urng.integers(0, SEQ_LEN + 4, nu)]
    cols["click_seq"] = pa.array(per_user(seqs))
    cols["query"] = pa.array(per_user([
        "\x1d".join(_pick(urng, WORDS, k)) for k in urng.integers(0, 4, nu)]))
    cols["ukv"] = pa.array(per_user([
        "\x1d".join(f"{c}:{v:.2f}" for c, v in zip(
            _pick(urng, CATES, k), urng.random(k)))
        for k in urng.integers(0, 4, nu)]))
    cols["kv_map"] = cols["ukv"]
    cols["nested"] = pa.array(per_user([
        "|".join(f"{c}^" + ",".join(f"{b}:{v:.2f}" for b, v in zip(
            _pick(urng, list(BRANDS), 3), urng.random(3)))
                 for c in _pick(urng, CATES, k))
        for k in urng.integers(0, 3, nu)]))

    item = rng.integers(0, N_ITEMS, n)
    cols["item_id"] = pa.array([f"i{j}" for j in item])
    cols["item_int"] = pa.array(item.astype(np.int64))
    cols["cate"] = pa.array(_pick(rng, CATES + ["c_new"], n, 0.02))
    cols["brand"] = pa.array(_pick(rng, list(BRANDS) + ["b_x"], n))
    price = np.round(rng.lognormal(3.0, 1.0, n), 2)
    cols["price"] = pa.array([None if m else f"{p:.2f}" for p, m in zip(
        price, rng.random(n) < 0.03)])
    cols["price_num"] = pa.array(price)
    cols["vec"] = pa.array(["\x1d".join(f"{x:.3f}" for x in row)
                            for row in rng.normal(size=(n, 4))])
    cols["title"] = pa.array([
        "\x1d".join(_pick(rng, WORDS, k)) for k in rng.integers(1, 5, n)])
    cols["text"] = pa.array([" ".join(_pick(rng, WORDS, k)) or None
                             for k in rng.integers(0, 5, n)])
    cols["ikv"] = pa.array([
        "\x1d".join(f"{c}:{v:.2f}" for c, v in zip(_pick(rng, CATES, k),
                                                    rng.random(k)))
        for k in rng.integers(0, 4, n)])
    cols["tags"] = pa.array(["\x1d".join(_pick(rng, TAGS, 4))
                             for _ in range(n)])
    cols["mask"] = pa.array(["\x1d".join(_pick(rng, ["0", "1", "true"], 4))
                             for _ in range(n)])

    # the planted click: a category effect, a user taste for some
    # categories, price
    planted = np.random.default_rng(99)
    cate_effect = planted.normal(size=13)
    taste = planted.normal(size=(N_USERS, 13))
    cate_idx = np.asarray([CATES.index(c) if c in CATES else 12
                           for c in cols["cate"].to_pylist()])
    logit = (1.5 * cate_effect[cate_idx]
             + taste[user_of, cate_idx]
             - 0.4 * (np.log10(price + 1) - 1.3))
    cols["label"] = pa.array(
        (rng.random(n) < 1 / (1 + np.exp(-logit))).astype(np.float32))
    return cols


# --- the config --------------------------------------------------------

def _features(emb: int, vocab_file: str, spm_model: str,
              with_combine: bool) -> str:
    cates = ", ".join(f'"{c}"' for c in CATES)
    brands = " ".join(f'vocab_dict {{ key: "{k}" value: {v} }}'
                      for k, v in BRANDS.items())
    fc = [
        f'id_feature {{ feature_name: "uid" expression: "user:user_id" '
        f"hash_bucket_size: {UID_BUCKETS} embedding_dim: {emb} }}",
        f'id_feature {{ feature_name: "cate" expression: "item:cate" '
        f'vocab_list: [{cates}] default_value: "c0" embedding_dim: {emb} }}',
        f'id_feature {{ feature_name: "brand" expression: "item:brand" '
        f"{brands} embedding_dim: {emb} }}",
        f'id_feature {{ feature_name: "city" expression: "user:city" '
        f'vocab_file: "{vocab_file}" embedding_dim: {emb} }}',
        f'id_feature {{ feature_name: "item_nb" expression: "item:item_int" '
        f"num_buckets: {N_ITEMS} embedding_dim: {emb} }}",
        f'id_feature {{ feature_name: "tags_w" expression: "user:tags_w" '
        f"hash_bucket_size: 200 weighted: true embedding_dim: {emb} }}",
        f'id_feature {{ feature_name: "tgt_item" expression: "item:item_id" '
        f"hash_bucket_size: {N_ITEMS * 2} embedding_dim: {emb} "
        'embedding_name: "item_emb" }',
        f'sequence_id_feature {{ feature_name: "click_seq" '
        f'expression: "user:click_seq" hash_bucket_size: {N_ITEMS * 2} '
        f"embedding_dim: {emb} sequence_length: {SEQ_LEN} "
        'embedding_name: "item_emb" }',
        'raw_feature { feature_name: "price" expression: "item:price" '
        'normalizer: "method=log10,threshold=1e-10,default=-10" }',
        f'raw_feature {{ feature_name: "age_b" expression: "user:age" '
        f"boundaries: [18, 25, 35, 50] embedding_dim: {emb} }}",
        'raw_feature { feature_name: "vec4" expression: "item:vec" '
        "value_dim: 4 }",
        f'combo_feature {{ feature_name: "city_x_cate" '
        f'expression: ["user:city", "item:cate"] hash_bucket_size: 500 '
        f"embedding_dim: {emb} }}",
        'lookup_feature { feature_name: "lk" map: "user:kv_map" '
        'key: "item:cate" }',
        'match_feature { feature_name: "mt" nested_map: "user:nested" '
        'pkey: "item:cate" skey: "item:brand" }',
        'expr_feature { feature_name: "ex" '
        'variables: ["item:price_num", "user:age"] '
        'expression: "log(price_num + 1) * sqrt(age)" }',
        'overlap_feature { feature_name: "ov" method: "query_common_ratio" '
        'expression: ["user:query", "item:title"] }',
        f'overlap_feature {{ feature_name: "ovb" method: "is_contain" '
        f'expression: ["user:query", "item:title"] boundaries: [0.5] '
        f"embedding_dim: {emb} }}",
        'kv_dot_product { feature_name: "kvd" '
        'expression: ["user:ukv", "item:ikv"] }',
        f'bool_mask_feature {{ feature_name: "bm" '
        f'expression: ["item:tags", "item:mask"] hash_bucket_size: 100 '
        f"embedding_dim: {emb} }}",
        f'tokenize_feature {{ feature_name: "tok" expression: "item:text" '
        f'vocab_file: "{spm_model}" tokenizer_type: "sentencepiece" '
        f"embedding_dim: {emb} }}",
        f'custom_feature {{ feature_name: "cus" operator_name: '
        f'"{CUSTOM_OP}" expression: ["item:title"] '
        f"num_buckets: {CUSTOM_BUCKETS} embedding_dim: {emb} }}",
    ]
    if with_combine:
        fc.append(
            f'combine_feature {{ feature_name: "cmb" '
            f'expression: ["feature:cate", "feature:age_b"] '
            f"hash_bucket_size: 300 embedding_dim: {emb} }}")
    return "\n".join(f"feature_configs {{ {f} }}" for f in fc)


SPARSE = ["uid", "cate", "brand", "city", "item_nb", "tags_w", "age_b",
          "city_x_cate", "ovb", "bm", "tok", "cus"]
DENSE = ["price", "vec4", "lk", "mt", "ex", "ov", "kvd"]


def fg_din_config_text(train_path: str, eval_path: str, model_dir: str,
                       vocab_file: str, spm_model: str, batch_size: int,
                       emb: int = 8, hidden=(32, 16),
                       with_combine: bool = True,
                       fg_threads: int = 1) -> str:
    """The MultiTowerDIN config over ``fg_raw_cols``: a DEEP group of
    every non-sequence feature and a DIN tower over (``tgt_item``,
    ``click_seq``); fp32, adam, rowwise adagrad on the tables."""
    sparse = SPARSE + (["cmb"] if with_combine else [])
    names = "".join(f' feature_names: "{f}"' for f in sparse + DENSE)
    mlp = ", ".join(str(h) for h in hidden)
    return f"""train_input_path: "{train_path}"
eval_input_path: "{eval_path}"
model_dir: "{model_dir}"
train_config {{
  sparse_optimizer {{ rowwise_adagrad_optimizer {{ lr: 0.02 }}
    constant_learning_rate {{}} }}
  dense_optimizer {{ adam_optimizer {{ lr: 0.002 }}
    constant_learning_rate {{}} }}
  num_epochs: 1
  use_tensorboard: false
}}
data_config {{
  batch_size: {batch_size}
  dataset_type: ParquetDataset
  fg_mode: FG_NORMAL
  fg_threads: {fg_threads}
  label_fields: "label"
}}
{_features(emb, vocab_file, spm_model, with_combine)}
model_config {{
  feature_groups {{ group_name: "all"{names} group_type: DEEP }}
  feature_groups {{ group_name: "seq" feature_names: "tgt_item"
    feature_names: "click_seq" group_type: SEQUENCE }}
  multi_tower_din {{
    towers {{ input: "all" mlp {{ hidden_units: [{mlp}] }} }}
    din_towers {{ input: "seq" attn_mlp {{ hidden_units: [{mlp}] }} }}
    final {{ hidden_units: [{hidden[-1]}] }}
  }}
  num_class: 1
  losses {{ binary_cross_entropy {{}} }}
  metrics {{ auc {{}} }}
}}
"""
