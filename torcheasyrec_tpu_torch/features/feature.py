"""Feature layer: BaseFeature, its registry and the fg-encoded parsers.

Counterpart of torcheasyrec_tpu/features/feature.py, cut to what id and
raw features (plain and sequence) need in FG_NONE mode, where the input
columns are already encoded. Host-side only (pyarrow/numpy): it turns
Arrow columns into numpy ids, lengths and dense values, and marks the
features a negative sampler appends rows to (``data_group``). A grouped
``sequence_feature`` config expands into one feature per sub-feature,
named ``{sequence_name}__{sub_name}``, each with the group's delimiter,
length and pk. The raw ids of ``zch`` and ``dynamicemb`` features pass
unbounded (the model remaps them, ``parallel/zch.py``); their table has
``zch_size`` or ``max_capacity`` rows. FG_NORMAL feature generation and
vocab files are not ported and raise NotImplementedError.
"""

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc

from torcheasyrec_tpu_torch.datasets.utils import (
    BASE_DATA_GROUP,
    NEG_DATA_GROUP,
)
from torcheasyrec_tpu_torch.utils.load_class import get_register_class_meta

_FEATURE_CLASS_MAP: Dict[str, type] = {}
_meta_cls = get_register_class_meta(_FEATURE_CLASS_MAP)

FG_NONE = 1  # data.proto FgMode.FG_NONE


# ---------------------------------------------------------------------------
# parsed data containers
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class SparseData:
    name: str
    values: np.ndarray  # int64 [N]
    lengths: np.ndarray  # int32 [B]
    weights: Optional[np.ndarray] = None  # float32 [N]


@dataclasses.dataclass
class DenseData:
    name: str
    values: np.ndarray  # float32 [B, D]


@dataclasses.dataclass
class SequenceSparseData:
    name: str
    values: np.ndarray  # int64 [N_total]
    lengths: np.ndarray  # int32 [N_steps]  (ids per step; usually all 1)
    seq_lengths: np.ndarray  # int32 [B]    (steps per sample)


@dataclasses.dataclass
class SequenceDenseData:
    name: str
    values: np.ndarray  # float32 [N_steps, D]
    seq_lengths: np.ndarray  # int32 [B]


# ---------------------------------------------------------------------------
# fg-encoded parsers
# ---------------------------------------------------------------------------


def _parse_fg_encoded_sparse(
    name: str,
    feat: pa.Array,
    multival_sep: str = chr(3),
    default_value: Optional[List[int]] = None,
    is_weighted: bool = False,
) -> SparseData:
    weight_values = None
    if pa.types.is_string(feat.type) or pa.types.is_list(feat.type) or pa.types.is_map(
        feat.type
    ):
        weight = None
        if pa.types.is_string(feat.type) or pa.types.is_list(feat.type):
            if pa.types.is_string(feat.type):
                is_empty = pc.equal(feat, pa.scalar(""))
                feat = pc.if_else(is_empty, pa.nulls(len(feat)), feat)
                feat = pc.split_pattern(feat, multival_sep)
            elif pa.types.is_list(feat.type) and default_value is not None:
                is_empty = pc.equal(pc.list_value_length(feat), 0)
                feat = pc.if_else(is_empty, pa.nulls(len(feat)), feat)
            if is_weighted:
                fw = pc.split_pattern(feat.values, ":")
                weight = pa.ListArray.from_arrays(
                    feat.offsets, fw.values[1::2], mask=feat.is_null()
                )
                feat = pa.ListArray.from_arrays(
                    feat.offsets, fw.values[::2], mask=feat.is_null()
                )
        else:  # map<k,v>
            weight = pa.ListArray.from_arrays(
                feat.offsets, feat.items, mask=feat.is_null()
            )
            feat = pa.ListArray.from_arrays(
                feat.offsets, feat.keys, mask=feat.is_null()
            )
        feat = feat.cast(pa.list_(pa.int64()), safe=False)
        if weight is not None:
            weight = weight.cast(pa.list_(pa.float32()), safe=False)
        if default_value is not None:
            feat = feat.fill_null(default_value)
            if weight is not None:
                weight = weight.fill_null([1.0])
        feat = feat.combine_chunks() if isinstance(feat, pa.ChunkedArray) else feat
        feat_values = feat.values.to_numpy(zero_copy_only=False)
        offs = feat.offsets.to_numpy()
        feat_lengths = (offs[1:] - offs[:-1]).astype(np.int32)
        if weight is not None:
            weight_values = weight.values.to_numpy(zero_copy_only=False)
    elif pa.types.is_integer(feat.type):
        if feat.null_count == 0:
            feat_values = feat.to_numpy(zero_copy_only=True)
            feat_lengths = np.ones((len(feat),), np.int32)
        elif default_value is not None:
            feat = feat.cast(pa.int64()).fill_null(default_value[0])
            feat_values = feat.to_numpy(zero_copy_only=False)
            feat_lengths = np.ones_like(feat_values, np.int32)
        else:
            feat_values = feat.drop_null().cast(pa.int64()).to_numpy(
                zero_copy_only=False
            )
            feat_lengths = (
                1 - feat.is_null().cast(pa.int32()).to_numpy(zero_copy_only=False)
            ).astype(np.int32)
    else:
        raise ValueError(
            f"{name}: unsupported fg-encoded sparse dtype {feat.type}"
        )
    return SparseData(
        name, feat_values.astype(np.int64, copy=False), feat_lengths,
        weight_values,
    )


def _parse_fg_encoded_dense(
    name: str,
    feat: pa.Array,
    multival_sep: str = chr(3),
    default_value: Optional[List[float]] = None,
) -> DenseData:
    if pa.types.is_string(feat.type):
        if default_value is not None:
            is_empty = pc.equal(feat, pa.scalar(""))
            feat = pc.if_else(is_empty, pa.nulls(len(feat)), feat)
            feat = feat.fill_null(multival_sep.join(map(str, default_value)))
        list_feat = pc.split_pattern(feat, multival_sep)
        list_feat = list_feat.cast(pa.list_(pa.float32()), safe=False)
        feat_values = np.stack(list_feat.to_numpy(zero_copy_only=False))
    elif pa.types.is_list(feat.type):
        feat = feat.cast(pa.list_(pa.float32()), safe=False)
        if default_value is not None:
            is_empty = pc.equal(pc.list_value_length(feat), 0)
            feat = pc.if_else(is_empty, pa.nulls(len(feat)), feat)
            feat = feat.fill_null(default_value)
        feat_values = np.stack(feat.to_numpy(zero_copy_only=False))
    elif pa.types.is_integer(feat.type) or pa.types.is_floating(feat.type):
        feat = feat.cast(pa.float32(), safe=False)
        if default_value is not None:
            feat = feat.fill_null(default_value[0])
        feat_values = feat.to_numpy(zero_copy_only=False)[:, np.newaxis]
    else:
        raise ValueError(f"{name}: unsupported fg-encoded dense dtype {feat.type}")
    return DenseData(name, np.nan_to_num(feat_values.astype(np.float32)))


def _parse_fg_encoded_sequence_sparse(
    name: str,
    feat: pa.Array,
    sequence_delim: str = ";",
    multival_sep: str = chr(3),
    default_value: Optional[List[int]] = None,
) -> SequenceSparseData:
    if pa.types.is_string(feat.type):
        is_empty = pc.equal(feat, pa.scalar(""))
        feat = pc.if_else(is_empty, pa.nulls(len(feat)), feat)
        if default_value is not None:
            feat = feat.fill_null(multival_sep.join(map(str, default_value)))
        list_seq_feat = pc.split_pattern(feat, sequence_delim)
        list_feat = pc.split_pattern(list_seq_feat.values, multival_sep)
        seq_offs = list_seq_feat.offsets.to_numpy()
        seq_lengths = (seq_offs[1:] - seq_offs[:-1]).astype(np.int32)
        # null rows keep equal offsets; they must map to length 0
        nulls = list_seq_feat.is_null().to_numpy(zero_copy_only=False)
        seq_lengths = np.where(nulls, 0, seq_lengths).astype(np.int32)
        feat_values = list_feat.values.cast(pa.int64()).to_numpy(
            zero_copy_only=False
        )
        offs = list_feat.offsets.to_numpy()
        feat_lengths = (offs[1:] - offs[:-1]).astype(np.int32)
    elif pa.types.is_list(feat.type):
        if pa.types.is_list(feat.type.value_type):
            feat = feat.cast(pa.list_(pa.list_(pa.int64())), safe=False)
            if default_value is not None:
                is_empty = pc.equal(pc.list_value_length(feat), 0)
                feat = pc.if_else(is_empty, pa.nulls(len(feat)), feat)
                feat = feat.fill_null([default_value])
            seq_offs = feat.offsets.to_numpy()
            seq_lengths = (seq_offs[1:] - seq_offs[:-1]).astype(np.int32)
            feat_values = feat.values.values.to_numpy(zero_copy_only=False)
            offs = feat.values.offsets.to_numpy()
            feat_lengths = (offs[1:] - offs[:-1]).astype(np.int32)
        else:
            feat = feat.cast(pa.list_(pa.int64()), safe=False)
            if default_value is not None:
                is_empty = pc.equal(pc.list_value_length(feat), 0)
                feat = pc.if_else(is_empty, pa.nulls(len(feat)), feat)
                feat = feat.fill_null(default_value)
            seq_offs = feat.offsets.to_numpy()
            seq_lengths = (seq_offs[1:] - seq_offs[:-1]).astype(np.int32)
            feat_values = feat.values.to_numpy(zero_copy_only=False)
            feat_lengths = np.ones_like(feat_values, dtype=np.int32)
    else:
        raise ValueError(f"{name}: unsupported sequence sparse dtype {feat.type}")
    return SequenceSparseData(
        name, feat_values.astype(np.int64), feat_lengths, seq_lengths
    )


def _parse_fg_encoded_sequence_dense(
    name: str,
    feat: pa.Array,
    sequence_delim: str = ";",
    multival_sep: str = chr(3),
    value_dim: int = 1,
    default_value: Optional[List[float]] = None,
) -> SequenceDenseData:
    if pa.types.is_string(feat.type):
        is_empty = pc.equal(feat, pa.scalar(""))
        feat = pc.if_else(is_empty, pa.nulls(len(feat)), feat)
        if default_value is not None:
            feat = feat.fill_null(multival_sep.join(map(str, default_value)))
        list_seq_feat = pc.split_pattern(feat, sequence_delim)
        list_feat = pc.split_pattern(list_seq_feat.values, multival_sep)
        seq_offs = list_seq_feat.offsets.to_numpy()
        seq_lengths = (seq_offs[1:] - seq_offs[:-1]).astype(np.int32)
        nulls = list_seq_feat.is_null().to_numpy(zero_copy_only=False)
        seq_lengths = np.where(nulls, 0, seq_lengths).astype(np.int32)
        feat_values = (
            list_feat.values.cast(pa.float32(), safe=False)
            .to_numpy(zero_copy_only=False)
            .reshape(-1, value_dim)
        )
    elif pa.types.is_list(feat.type):
        if pa.types.is_list(feat.type.value_type):
            feat = feat.cast(pa.list_(pa.list_(pa.float32())), safe=False)
            if default_value is not None:
                is_empty = pc.equal(pc.list_value_length(feat), 0)
                feat = pc.if_else(is_empty, pa.nulls(len(feat)), feat)
                feat = feat.fill_null([default_value])
            seq_offs = feat.offsets.to_numpy()
            seq_lengths = (seq_offs[1:] - seq_offs[:-1]).astype(np.int32)
            feat_values = feat.values.values.to_numpy(zero_copy_only=False).reshape(
                -1, value_dim
            )
        else:
            feat = feat.cast(pa.list_(pa.float32()), safe=False)
            if default_value is not None:
                is_empty = pc.equal(pc.list_value_length(feat), 0)
                feat = pc.if_else(is_empty, pa.nulls(len(feat)), feat)
                feat = feat.fill_null(default_value)
            seq_offs = feat.offsets.to_numpy()
            seq_lengths = (seq_offs[1:] - seq_offs[:-1]).astype(np.int32)
            feat_values = feat.values.to_numpy(zero_copy_only=False).reshape(
                -1, value_dim
            )
    else:
        raise ValueError(f"{name}: unsupported sequence dense dtype {feat.type}")
    return SequenceDenseData(
        name, np.nan_to_num(feat_values.astype(np.float32)), seq_lengths
    )


# ---------------------------------------------------------------------------
# BaseFeature
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class EmbConfig:
    """Per-table embedding config fed to the embedding group."""

    name: str
    num_embeddings: int
    embedding_dim: int
    init_fn: Optional[str] = None
    sharding_types: Tuple[str, ...] = ()


def _has_field_safe(msg, name: str) -> bool:
    try:
        return msg.HasField(name)
    except ValueError:
        return False


class BaseFeature(metaclass=_meta_cls):
    """One feature column family (FG_NONE input)."""

    def __init__(
        self,
        feature_config: Any,
        fg_mode: int = FG_NONE,
        fg_encoded_multival_sep: Optional[str] = None,
    ) -> None:
        if fg_mode != FG_NONE:
            raise NotImplementedError(
                "only fg_mode FG_NONE (pre-encoded input) is ported"
            )
        self._feature_config = feature_config
        oneof = feature_config.WhichOneof("feature")
        self.config = getattr(feature_config, oneof)
        self._oneof_name = oneof
        self._is_seq_oneof = oneof.startswith("sequence_")
        # set on the sub-features of a grouped sequence_feature
        self.sequence_name: Optional[str] = None
        self.sequence_delim: Optional[str] = None
        self.sequence_length: Optional[int] = None
        self.sequence_pk: Optional[str] = None
        self._multival_sep = fg_encoded_multival_sep or chr(3)
        # a tuple once computed; None (not a sentinel object) until then,
        # so that a pickled feature (a loader worker's) compares right
        self._id_bound_cache = None
        self._data_group = BASE_DATA_GROUP
        if getattr(self.config, "vocab_file", ""):
            raise NotImplementedError(
                f"feature {self.name}: vocab_file is not ported"
            )

    # -- identity ----------------------------------------------------------

    @property
    def name(self) -> str:
        if self.sequence_name:
            return f"{self.sequence_name}__{self.config.feature_name}"
        return self.config.feature_name

    @property
    def is_sequence(self) -> bool:
        return self._is_seq_oneof or self.sequence_name is not None

    @property
    def is_weighted(self) -> bool:
        return bool(getattr(self.config, "weighted", False))

    @property
    def effective_sequence_length(self) -> int:
        if self.sequence_length:
            return int(self.sequence_length)
        return int(getattr(self.config, "sequence_length", 0) or 0)

    @property
    def is_sparse(self) -> bool:
        raise NotImplementedError

    @property
    def value_dim(self) -> int:
        return int(getattr(self.config, "value_dim", 0) or 0)

    # -- embedding table config -------------------------------------------

    @property
    def num_embeddings(self) -> int:
        c = self.config
        if getattr(c, "hash_bucket_size", 0):
            return int(c.hash_bucket_size)
        if getattr(c, "num_buckets", 0):
            return int(c.num_buckets)
        if len(getattr(c, "vocab_list", [])):
            dbv = int(getattr(c, "default_bucketize_value", 0) or 0)
            if _has_field_safe(c, "default_bucketize_value"):
                return max(len(c.vocab_list), dbv + 1)
            # id 0 reserved for default, 1 for oov
            return len(c.vocab_list) + 2
        if len(getattr(c, "vocab_dict", {})):
            dbv = int(getattr(c, "default_bucketize_value", 0) or 1)
            return max(max(c.vocab_dict.values()), dbv) + 1
        if len(getattr(c, "boundaries", [])):
            return len(c.boundaries) + 1
        if _has_field_safe(c, "zch"):
            return int(c.zch.zch_size)
        if _has_field_safe(c, "dynamicemb"):
            return int(c.dynamicemb.max_capacity)
        raise ValueError(f"feature {self.name}: cannot infer id space size")

    @property
    def is_zch(self) -> bool:
        """Ids are raw and remapped on the device (``zch`` or
        ``dynamicemb``, ``parallel/zch.py``)."""
        return (_has_field_safe(self.config, "zch")
                or _has_field_safe(self.config, "dynamicemb"))

    @property
    def embedding_name(self) -> str:
        return getattr(self.config, "embedding_name", "") or f"{self.name}_emb"

    @property
    def pooling(self) -> str:
        return (getattr(self.config, "pooling", "sum") or "sum").lower()

    def emb_config(self) -> Optional[EmbConfig]:
        if not self.is_sparse:
            return None
        constraints = ()
        ec = getattr(self.config, "embedding_constraints", None)
        if ec is not None and len(ec.sharding_types):
            constraints = tuple(ec.sharding_types)
        return EmbConfig(
            name=self.embedding_name,
            num_embeddings=self.num_embeddings,
            embedding_dim=int(self.config.embedding_dim),
            init_fn=getattr(self.config, "init_fn", "") or None,
            sharding_types=constraints,
        )

    # -- input wiring ------------------------------------------------------

    @property
    def inputs(self) -> List[str]:
        """In FG_NONE mode the input column is the feature name itself."""
        return [self.name]

    @property
    def side_inputs(self) -> List[Tuple[str, str]]:
        """[(side, column)] of the config's ``expression``s, written
        ``side:column`` (side "user", "item" or "context"; "" where the
        expression names a column alone)."""
        expr = getattr(self.config, "expression", None)
        exprs = ([expr] if expr else []) if isinstance(expr, str) else list(
            expr or [])
        return [tuple(e.split(":", 1)) if ":" in e else ("", e)
                for e in exprs]

    @property
    def is_item_side(self) -> bool:
        return any(side == "item" for side, _ in self.side_inputs)

    @property
    def data_group(self) -> str:
        """``NEG_DATA_GROUP`` where the negative sampler appends rows to
        this feature's input, else ``BASE_DATA_GROUP``."""
        return self._data_group

    def set_data_group(self, group: str) -> None:
        self._data_group = group

    @property
    def effective_sequence_delim(self) -> str:
        return (self.sequence_delim
                or getattr(self.config, "sequence_delim", ";") or ";")

    def _fg_encoded_default(self) -> Optional[List[Any]]:
        dv = getattr(self.config, "fg_encoded_default_value", "")
        if not dv:
            return None
        if self.is_sparse:
            return [int(x) for x in dv.split(self._multival_sep)]
        return [float(x) for x in dv.split(self._multival_sep)]

    # -- parse -------------------------------------------------------------

    def parse(self, input_data: Dict[str, pa.Array]) -> Any:
        """Arrow columns -> parsed numpy data."""
        feat = self._input_column(input_data)
        default = self._fg_encoded_default()
        if self.is_sequence:
            delim = self.effective_sequence_delim
            if self.is_sparse:
                return self._enforce_id_bound(
                    _parse_fg_encoded_sequence_sparse(
                        self.name, feat, delim, self._multival_sep, default
                    )
                )
            return _parse_fg_encoded_sequence_dense(
                self.name, feat, delim, self._multival_sep,
                max(self.value_dim, 1), default,
            )
        if self.is_sparse:
            return self._enforce_id_bound(_parse_fg_encoded_sparse(
                self.name, feat, self._multival_sep, default, self.is_weighted
            ))
        return _parse_fg_encoded_dense(
            self.name, feat, self._multival_sep, default
        )

    def _input_column(self, input_data: Dict[str, pa.Array]) -> pa.Array:
        col = self.inputs[0]
        if col not in input_data:
            raise KeyError(
                f"feature {self.name}: input column {col!r} missing; "
                f"have {sorted(input_data)[:20]}"
            )
        arr = input_data[col]
        if isinstance(arr, pa.ChunkedArray):
            arr = arr.combine_chunks()
        if pa.types.is_null(arr.type):
            arr = arr.cast(pa.string())
        return arr

    def _id_bound(self):
        """Range guard for pre-encoded ids: an id past its table's rows
        is wrapped (hash buckets) or clipped (everything else); the raw
        ids of ZCH features pass unbounded (("none", 0))."""
        if self._id_bound_cache is not None:
            return self._id_bound_cache
        c = self.config
        if self.is_zch:
            bound = ("none", 0)
        elif getattr(c, "hash_bucket_size", 0):
            bound = ("mod", int(c.hash_bucket_size))
        else:
            bound = ("clip", int(self.num_embeddings))
        self._id_bound_cache = bound
        return bound

    def _enforce_id_bound(self, parsed):
        mode, n = self._id_bound()
        v = parsed.values
        if mode == "none" or v.size == 0 or int(v.max()) < n:
            return parsed
        if mode == "mod":
            v = np.where(v >= n, v % n, v)
        else:
            v = np.where(v >= n, n - 1, v)
        return dataclasses.replace(parsed, values=v)

    # -- fg.json: the serving contract ---------------------------------------

    def fg_json(self) -> Dict[str, Any]:
        """This feature's entry of ``fg.json``, as the JAX package writes
        it: a grouped sub-feature keeps its bare name (the group carries
        the prefix); a standalone sequence feature keeps its ``sequence_``
        type, delimiter and length; sequence features get a default of
        "0"; the config's serve-time fields follow."""
        c = self.config
        out: Dict[str, Any] = {
            "feature_name": (c.feature_name if self.sequence_name
                             else self.name),
            "feature_type": (self._oneof_name if self._is_seq_oneof
                             else self._oneof_name.replace("sequence_", "")),
        }
        if self._is_seq_oneof:
            out["sequence_delim"] = getattr(c, "sequence_delim", ";")
            if self.effective_sequence_length:
                out["sequence_length"] = self.effective_sequence_length
        if self.is_sequence and not getattr(c, "default_value", ""):
            out["default_value"] = "0"
        if out["feature_type"] == "expr_feature":
            out["expression"] = getattr(c, "expression", "")
        else:
            expr = getattr(c, "expression", None)
            exprs = (([expr] if expr else []) if isinstance(expr, str)
                     else list(expr or []))
            if len(exprs) == 1:
                out["expression"] = exprs[0]
            elif exprs:
                out["expression"] = exprs
        for field in ("default_value", "separator", "hash_bucket_size",
                      "num_buckets", "value_dim", "embedding_dim",
                      "normalizer", "map", "key", "method", "vocab_file"):
            v = getattr(c, field, None)
            if v:
                out[field] = (v if not hasattr(v, "__len__")
                              or isinstance(v, (str, bytes)) else list(v))
        for field in ("boundaries", "vocab_list", "variables"):
            if len(getattr(c, field, [])):
                out[field] = list(getattr(c, field))
        if out["feature_type"] == "match_feature":
            for src, dst in (("nested_map", "user"), ("pkey", "category"),
                             ("skey", "item")):
                v = getattr(c, src, "")
                if v:
                    out[dst] = v
        return out


def create_fg_json(features: List[BaseFeature]) -> Dict[str, Any]:
    """The serving-side ``fg.json`` of ``features``: standalone features
    in order, then one entry per grouped sequence with its
    sub-features."""
    out: Dict[str, Any] = {"features": []}
    seq_groups: Dict[str, Dict[str, Any]] = {}
    for f in features:
        if not f.sequence_name:
            out["features"].append(f.fg_json())
            continue
        g = seq_groups.setdefault(f.sequence_name, {
            "sequence_name": f.sequence_name,
            "sequence_length": f.sequence_length,
            "sequence_delim": f.sequence_delim,
            **({"sequence_pk": f.sequence_pk} if f.sequence_pk else {}),
            "features": [],
        })
        g["features"].append(f.fg_json())
    out["features"].extend(seq_groups.values())
    return out


def create_features(
    feature_configs: List[Any],
    fg_mode: int = FG_NONE,
    fg_encoded_multival_sep: Optional[str] = None,
    neg_fields: Optional[List[str]] = None,
) -> List[BaseFeature]:
    """Build feature objects from FeatureConfig protos. With ``neg_fields``
    (the negative sampler's attr fields), item-side features and those
    whose input is one of the fields join ``NEG_DATA_GROUP``. A grouped
    ``sequence_feature`` gives one feature per sub-feature, named
    ``{sequence_name}__{sub_name}``."""
    features: List[BaseFeature] = []
    for cfg in feature_configs:
        oneof = cfg.WhichOneof("feature")
        if oneof == "sequence_feature":
            seq_cfg = cfg.sequence_feature
            for sub in seq_cfg.features:
                feat = BaseFeature.create_class(
                    _oneof_to_class(sub.WhichOneof("feature")))(
                    sub, fg_mode, fg_encoded_multival_sep)
                feat.sequence_name = seq_cfg.sequence_name
                feat.sequence_delim = seq_cfg.sequence_delim
                feat.sequence_length = int(seq_cfg.sequence_length)
                feat.sequence_pk = seq_cfg.sequence_pk or None
                features.append(feat)
            continue
        cls_name = _oneof_to_class(oneof.replace("sequence_", ""))
        features.append(BaseFeature.create_class(cls_name)(
            cfg, fg_mode, fg_encoded_multival_sep
        ))
    if neg_fields:
        for feat in features:
            if feat.is_item_side or set(feat.inputs) & set(neg_fields):
                feat.set_data_group(NEG_DATA_GROUP)
    return features


def _oneof_to_class(oneof: str) -> str:
    """id_feature -> IdFeature etc."""
    return "".join(p.capitalize() for p in oneof.split("_"))
