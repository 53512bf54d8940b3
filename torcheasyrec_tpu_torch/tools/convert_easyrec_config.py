"""Convert TF-EasyRec configs (+ optional fg.json) to the port's
pipeline configs.

Counterpart of torcheasyrec_tpu/tools/convert_easyrec_config.py, the same
converter over the port's own protos (``tzrec_tpu_torch.protos``): the
TF EasyRec proto schema is not a dependency, so the text format is
parsed generically (a proto text config is ``key: value`` and ``key {
... }`` blocks) and the port's proto objects are built from it, so the
emitted config is validated by construction and round-trips through
text_format. Covered:

* train_config: optimizer_config -> dense/sparse optimizers with the
  real learning rate + schedule (constant / exponential_decay), falling
  back to adam@0.001.
* data_config: batch_size, label fields (from task towers when absent),
  an input_type warning.
* features from fg.json (``--fg_json_path``): id/raw/combo/lookup/
  match/expr/overlap/tokenize/kv_dot_product/bool_mask + grouped
  sequence features with sub-features, via the pyfg key map.
* features from easyrec feature_config when no fg.json: IdFeature,
  TagFeature (kv_separator -> weighted), RawFeature (boundaries),
  SequenceFeature (sub_feature_type id/raw), ComboFeature,
  LookupFeature, ExprFeature.
* model_config: feature groups (wide_deep -> group_type, sequence
  groups), and per-model dims for DeepFM / WideAndDeep / MultiTower /
  DCN / MaskNet / MMoE / DBMTL / PLE / SimpleMultiTask / DSSM with
  dnn->mlp hidden_units and task-tower loss/metric mapping.

Anything unmapped is reported as a warning, word for word the JAX
package's, so the user can finish by hand.

    python -m torcheasyrec_tpu_torch.tools.convert_easyrec_config \
        --easyrec_config_path easyrec.config \
        --output_tzrec_config_path pipeline.config [--fg_json_path fg.json]
"""

import argparse
import json
import re
from typing import Any, Dict, List, Optional, Tuple, Union

from google.protobuf import text_format

Node = Dict[str, List[Union[str, "Node"]]]


# --------------------------------------------------------------- parsing


def parse_text_proto(text: str) -> Node:
    """Generic text-format parser -> nested dict of repeated values."""
    text = re.sub(r"#[^\n]*", "", text)
    tokens: List[str] = []
    for m in re.finditer(
        r"\"(?:[^\"\\]|\\.)*\"|'(?:[^'\\]|\\.)*'|[{}\[\]:,]|[^\s{}\[\]:,]+",
        text,
    ):
        tokens.append(m.group(0))

    def _parse_block(i: int) -> Tuple[Node, int]:
        node: Node = {}
        while i < len(tokens):
            t = tokens[i]
            if t == "}":
                return node, i + 1
            if t in (",", "]"):
                i += 1
                continue
            key = t
            i += 1
            if i < len(tokens) and tokens[i] == ":":
                i += 1
                if tokens[i] == "[":
                    i += 1
                    while i < len(tokens) and tokens[i] != "]":
                        if tokens[i] != ",":
                            node.setdefault(key, []).append(
                                tokens[i].strip("'\"")
                            )
                        i += 1
                    i += 1
                elif tokens[i] == "{":
                    sub, i = _parse_block(i + 1)
                    node.setdefault(key, []).append(sub)
                else:
                    node.setdefault(key, []).append(tokens[i].strip("'\""))
                    i += 1
            elif i < len(tokens) and tokens[i] == "{":
                sub, i = _parse_block(i + 1)
                node.setdefault(key, []).append(sub)
            else:
                node.setdefault(key, []).append("true")
        return node, i

    node, _ = _parse_block(0)
    return node


def _one(node: Node, key: str, default=None):
    v = node.get(key) if isinstance(node, dict) else None
    return v[0] if v else default


def _many(node: Node, key: str) -> List[Any]:
    return list(node.get(key, [])) if isinstance(node, dict) else []


def _as_int(v, default=0) -> int:
    try:
        return int(float(v))
    except (TypeError, ValueError):
        return default


def _as_float(v, default=0.0) -> float:
    try:
        return float(v)
    except (TypeError, ValueError):
        return default


# ------------------------------------------------------------ optimizers


def _convert_optimizer(tc: Node, pipeline, warnings: List[str]) -> None:
    """TF optimizer_config -> dense + sparse optimizers (the sparse side
    mirrors the dense choice when fusable, else adagrad)."""
    train = pipeline.train_config
    oc = _one(tc, "optimizer_config", {})
    kind = next(
        (k for k in ("adam_optimizer", "adam_async_optimizer",
                     "adagrad_optimizer", "sgd_optimizer",
                     "momentum_optimizer", "ftrl_optimizer")
         if isinstance(oc, dict) and k in oc),
        None,
    )
    lr_value, schedule = 0.001, None
    if kind:
        opt = _one(oc, kind, {})
        lr = _one(opt, "learning_rate", {})
        for which in ("constant_learning_rate",
                      "exponential_decay_learning_rate"):
            sub = _one(lr, which)
            if sub is not None:
                lr_value = _as_float(
                    _one(sub, "learning_rate",
                         _one(sub, "initial_learning_rate", 0.001)),
                    0.001,
                )
                if which == "exponential_decay_learning_rate":
                    schedule = sub
                break
    dense_kind = {
        "adam_optimizer": "adam_optimizer",
        "adam_async_optimizer": "adam_optimizer",
        "adagrad_optimizer": "adagrad_optimizer",
        "sgd_optimizer": "sgd_optimizer",
        "momentum_optimizer": "sgd_optimizer",
    }.get(kind or "adam_optimizer", "adam_optimizer")
    if kind in ("ftrl_optimizer",):
        warnings.append(
            f"optimizer {kind} has no counterpart; using adagrad/adam "
            "defaults — review learning rates"
        )
        dense_kind = "adam_optimizer"
    getattr(train.dense_optimizer, dense_kind).lr = lr_value
    sparse_kind = (
        dense_kind if dense_kind in ("adagrad_optimizer", "sgd_optimizer",
                                     "adam_optimizer")
        else "adagrad_optimizer"
    )
    getattr(train.sparse_optimizer, sparse_kind).lr = lr_value

    for holder in (train.dense_optimizer, train.sparse_optimizer):
        if schedule is not None:
            ed = holder.exponential_decay_learning_rate
            ed.decay_size = max(
                _as_int(_one(schedule, "decay_steps", 1000), 1000), 1
            )
            ed.decay_factor = _as_float(
                _one(schedule, "decay_factor", 0.95), 0.95
            )
            mn = _one(schedule, "min_learning_rate")
            if mn is not None:
                ed.min_learning_rate = _as_float(mn)
        else:
            holder.constant_learning_rate.SetInParent()
    for k in ("num_steps", "save_checkpoints_steps",
              "log_step_count_steps", "num_epochs"):
        v = _one(tc, k)
        if v is not None:
            setattr(train, k, _as_int(v))
    if not _one(tc, "num_steps") and not _one(tc, "num_epochs"):
        train.num_epochs = 1
    if _one(tc, "sync_replicas") == "false":
        warnings.append(
            "train_config.sync_replicas=false (async PS training) has no "
            "TPU counterpart; converted to synchronous SPMD"
        )


# -------------------------------------------------------------- features

# pyfg fg.json key -> our feature proto field
_FG_KEY_MAP = {
    "feature_name": "feature_name",
    "expression": "expression",
    "default_value": "default_value",
    "separator": "separator",
    "hash_bucket_size": "hash_bucket_size",
    "vocab_list": "vocab_list",
    "vocab_file": "vocab_file",
    "value_dim": "value_dim",
    "value_dimension": "value_dim",
    "default_bucketize_value": "default_bucketize_value",
    "normalizer": "normalizer",
    "boundaries": "boundaries",
    "variables": "variables",
    "expression_raw": "expression",
    "num_buckets": "num_buckets",
    "weighted": "weighted",
    "query": "query",
    "combiner": "pooling",
    "user": "nested_map",
    "category": "pkey",
    "item": "skey",
    "title": "title",
    "method": "method",
    "map": "map",
    "key": "key",
    "embedding_dim": "embedding_dim",
    "embedding_name": "embedding_name",
    "sequence_length": "sequence_length",
}

_FG_TYPE_TO_ONEOF = {
    "id_feature": "id_feature",
    "raw_feature": "raw_feature",
    "combo_feature": "combo_feature",
    "lookup_feature": "lookup_feature",
    "match_feature": "match_feature",
    "expr_feature": "expr_feature",
    "overlap_feature": "overlap_feature",
    "tokenize_feature": "tokenize_feature",
    "kv_dot_product": "kv_dot_product",
    "bool_mask_feature": "bool_mask_feature",
}

_INT_FIELDS = {"hash_bucket_size", "num_buckets", "embedding_dim",
               "value_dim", "default_bucketize_value", "sequence_length"}
_FLOAT_LIST_FIELDS = {"boundaries"}
_BOOL_FIELDS = {"weighted"}


def _apply_fg_fields(msg, fg: Dict[str, Any], warnings: List[str],
                     ctx: str) -> None:
    for k, v in fg.items():
        field = _FG_KEY_MAP.get(k)
        if field is None or not hasattr(msg, field):
            if k not in ("feature_type", "features", "sequence_name",
                         "sequence_delim", "sequence_length",
                         "attribute_delim", "group_type", "stub_type",
                         "need_prefix"):
                warnings.append(f"{ctx}: fg key {k!r} not mapped")
            continue
        try:
            if field in _FLOAT_LIST_FIELDS:
                getattr(msg, field).extend(float(x) for x in v)
            elif isinstance(v, list):
                getattr(msg, field).extend(str(x) for x in v)
            elif field in _INT_FIELDS:
                setattr(msg, field, _as_int(v))
            elif field in _BOOL_FIELDS:
                setattr(msg, field, bool(v))
            else:
                setattr(msg, field, str(v))
        except (TypeError, ValueError) as e:
            warnings.append(f"{ctx}: fg key {k}={v!r}: {e}")


def _features_from_fg_json(fg_json: Dict[str, Any], pipeline,
                           warnings: List[str]) -> None:
    from torcheasyrec_tpu_torch.protos import feature_pb2

    for fg in fg_json.get("features", []):
        fc = pipeline.feature_configs.add()
        if "feature_type" in fg:
            oneof = _FG_TYPE_TO_ONEOF.get(fg["feature_type"])
            if oneof is None:
                warnings.append(
                    f"fg feature {fg.get('feature_name')}: type "
                    f"{fg['feature_type']} unsupported; skipped"
                )
                pipeline.feature_configs.pop()
                continue
            _apply_fg_fields(getattr(fc, oneof), fg, warnings,
                             str(fg.get("feature_name")))
        elif "sequence_name" in fg:
            seq = fc.sequence_feature
            seq.sequence_name = str(fg["sequence_name"])
            seq.sequence_length = _as_int(fg.get("sequence_length", 50))
            if fg.get("sequence_delim"):
                seq.sequence_delim = str(fg["sequence_delim"])
            for sub in fg.get("features", []):
                sf = seq.features.add()
                sub_oneof = (
                    "id_feature"
                    if sub.get("feature_type") == "id_feature"
                    else "raw_feature"
                )
                _apply_fg_fields(
                    getattr(sf, sub_oneof), sub, warnings,
                    f"{fg['sequence_name']}.{sub.get('feature_name')}",
                )
        else:
            warnings.append(f"fg entry not understood: {list(fg)[:4]}")
            pipeline.feature_configs.pop()


def _features_from_easyrec(src: Node, pipeline,
                           warnings: List[str]) -> None:
    for fc_block in src.get("feature_config", []) + src.get(
        "feature_configs", []
    ):
        if isinstance(fc_block, str):
            continue
        feats = fc_block.get("features", []) or [fc_block]
        for feat in feats:
            if isinstance(feat, str):
                continue
            ftype = _one(feat, "feature_type", "IdFeature")
            name = _one(feat, "feature_name",
                        _one(feat, "input_names", "f"))
            inputs = _many(feat, "input_names")
            fc = pipeline.feature_configs.add()
            if ftype in ("IdFeature", "TagFeature"):
                m = fc.id_feature
                m.feature_name = name
                if _one(feat, "kv_separator") is not None:
                    m.weighted = True
            elif ftype == "RawFeature":
                m = fc.raw_feature
                m.feature_name = name
            elif ftype == "SequenceFeature":
                sub = _one(feat, "sub_feature_type", "IdFeature")
                m = (fc.sequence_id_feature if sub == "IdFeature"
                     else fc.sequence_raw_feature)
                m.feature_name = name
                m.sequence_length = _as_int(
                    _one(feat, "sequence_length", 50), 50
                )
                sep = _one(feat, "separator")
                if sep:
                    m.sequence_delim = sep
            elif ftype == "ComboFeature":
                m = fc.combo_feature
                m.feature_name = name
                m.expression.extend(inputs)
            elif ftype == "LookupFeature":
                m = fc.lookup_feature
                m.feature_name = name
                m.expression.extend(inputs[:2])
            elif ftype == "ExprFeature":
                m = fc.expr_feature
                m.feature_name = name
                m.expression = _one(feat, "expression", "")
                m.variables.extend(inputs)
            else:
                warnings.append(
                    f"feature {name}: feature_type {ftype} unsupported; "
                    "skipped"
                )
                pipeline.feature_configs.pop()
                continue
            for k in ("embedding_dim", "hash_bucket_size", "num_buckets"):
                v = _one(feat, k)
                if v is not None and hasattr(m, k):
                    setattr(m, k, _as_int(v))
            for k in ("embedding_name", "default_value", "separator"):
                v = _one(feat, k)
                if v is not None and hasattr(m, k) and k != "separator":
                    setattr(m, k, v)
            bl = _many(feat, "boundaries")
            if bl and hasattr(m, "boundaries"):
                m.boundaries.extend(float(b) for b in bl)
            vl = _many(feat, "vocab_list")
            if vl and hasattr(m, "vocab_list"):
                m.vocab_list.extend(vl)


# ----------------------------------------------------------------- model


def _dnn_units(node: Node, key: str) -> List[int]:
    dnn = _one(node, key, {})
    return [_as_int(u) for u in _many(dnn, "hidden_units")]


def _set_mlp(mlp, units: List[int], default=(128, 64)) -> None:
    mlp.hidden_units.extend(units or list(default))


def _convert_task_tower(t: Node, tz, warnings: List[str]) -> None:
    tz.tower_name = _one(t, "tower_name", "task")
    label = _one(t, "label_name", _one(t, "label_fields"))
    if label:
        tz.label_name = label
    _set_mlp(tz.mlp, _dnn_units(t, "dnn"))
    loss_types = [str(x).upper() for x in _many(t, "loss_type")]
    if any("L2" in lt or "REGRESSION" in lt for lt in loss_types):
        tz.losses.add().l2_loss.SetInParent()
        tz.metrics.add().mean_squared_error.SetInParent()
    else:
        tz.losses.add().binary_cross_entropy.SetInParent()
        tz.metrics.add().auc.SetInParent()
    for ms in _many(t, "metrics_set"):
        if isinstance(ms, dict) and "gauc" in ms:
            g = tz.metrics.add().grouped_auc
            uid = _one(_one(ms, "gauc", {}), "uid_field")
            if uid:
                g.grouping_key = uid
    w = _one(t, "weight")
    if w is not None and hasattr(tz, "weight"):
        tz.weight = _as_float(w, 1.0)


def _convert_model(src_mc: Node, mc, warnings: List[str]) -> None:
    model_class = _one(src_mc, "model_class", "")
    # EasyRec nests the model oneof under a lowercase block
    body_key = {
        "DeepFM": "deepfm", "WideAndDeep": "wide_and_deep",
        "MultiTower": "multi_tower", "DCN": "dcn",
        "MaskNet": "masknet", "MMoE": "mmoe", "DBMTL": "dbmtl",
        "PLE": "ple", "SimpleMultiTask": "simple_multi_task",
        "DSSM": "dssm",
    }.get(model_class)
    body = _one(src_mc, body_key, {}) if body_key else {}

    if model_class == "DeepFM":
        m = mc.deepfm
        _set_mlp(m.deep, _dnn_units(body, "dnn"))
        final = _dnn_units(body, "final_dnn")
        if final:
            _set_mlp(m.final, final)
        w = _one(body, "wide_output_dim")
        if w is not None:
            m.wide_embedding_dim = _as_int(w)
    elif model_class == "WideAndDeep":
        m = mc.wide_and_deep
        _set_mlp(m.deep, _dnn_units(body, "dnn"))
        final = _dnn_units(body, "final_dnn")
        if final:
            _set_mlp(m.final, final)
    elif model_class == "MultiTower":
        m = mc.multi_tower
        for tw in _many(body, "towers"):
            t = m.towers.add()
            t.input = _one(tw, "input", "deep")
            _set_mlp(t.mlp, _dnn_units(tw, "dnn"))
        _set_mlp(m.final, _dnn_units(body, "final_dnn"))
    elif model_class == "DCN":
        m = mc.dcn_v1
        cross = _one(body, "cross_tower", {})
        m.cross.cross_num = _as_int(_one(cross, "cross_num", 3), 3)
        deep = _one(body, "deep_tower", {})
        _set_mlp(m.deep, _dnn_units(deep, "dnn"))
        _set_mlp(m.final, _dnn_units(body, "final_dnn"))
    elif model_class == "MMoE":
        m = mc.mmoe
        _set_mlp(m.expert_mlp, _dnn_units(body, "expert_dnn"))
        m.num_expert = _as_int(_one(body, "num_expert", 2), 2)
        for t in _many(body, "task_towers"):
            _convert_task_tower(t, m.task_towers.add(), warnings)
    elif model_class == "DBMTL":
        m = mc.dbmtl
        _set_mlp(m.bottom_mlp, _dnn_units(body, "bottom_dnn"))
        ed = _dnn_units(body, "expert_dnn")
        if ed:
            _set_mlp(m.expert_mlp, ed)
            m.num_expert = _as_int(_one(body, "num_expert", 1), 1)
        for t in _many(body, "task_towers"):
            tz = m.task_towers.add()
            _convert_task_tower(t, tz, warnings)
            for rel in _many(t, "relation_tower_names"):
                tz.relation_tower_names.append(rel)
            rd = _dnn_units(t, "relation_dnn")
            if rd:
                _set_mlp(tz.relation_mlp, rd)
    elif model_class == "PLE":
        m = mc.ple
        for en in _many(body, "extraction_networks"):
            tz_en = m.extraction_networks.add()
            tz_en.network_name = _one(en, "network_name", "layer")
            tz_en.expert_num_per_task = _as_int(
                _one(en, "expert_num_per_task", 1), 1
            )
            tz_en.share_num = _as_int(_one(en, "share_num", 1), 1)
            _set_mlp(tz_en.task_expert_net,
                     _dnn_units(en, "task_expert_net"))
            _set_mlp(tz_en.share_expert_net,
                     _dnn_units(en, "share_expert_net"))
        for t in _many(body, "task_towers"):
            _convert_task_tower(t, m.task_towers.add(), warnings)
    elif model_class == "SimpleMultiTask":
        m = mc.simple_multi_task
        for t in _many(body, "task_towers"):
            _convert_task_tower(t, m.task_towers.add(), warnings)
    elif model_class == "DSSM":
        m = mc.dssm
        for side in ("user_tower", "item_tower"):
            tw = _one(body, side, {})
            tz_t = getattr(m, side)
            tz_t.input = _one(tw, "id", _one(
                tw, "input", "user" if side == "user_tower" else "item"
            ))
            _set_mlp(tz_t.mlp, _dnn_units(tw, "dnn"))
        m.output_dim = 32
        temp = _one(body, "temperature")
        if temp is not None:
            m.temperature = _as_float(temp, 1.0)
    elif model_class == "MaskNet":
        m = mc.mask_net.mask_net_module
        m.n_mask_blocks = _as_int(_one(body, "n_mask_blocks", 3), 3)
        mb = m.mask_block
        mb.hidden_dim = 64
        mb.aggregation_dim = 32
        _set_mlp(m.top_mlp, _dnn_units(body, "top_mlp"))
        warnings.append(
            "MaskNet block dims defaulted (hidden 64 / agg 32); review"
        )
    else:
        warnings.append(
            f"model_class {model_class!r} has no direct mapping; fill "
            "model_config manually"
        )

    # model-level losses/metrics for single-task models
    if model_class in ("DeepFM", "WideAndDeep", "MultiTower", "DCN",
                       "MaskNet", "DSSM"):
        mc.losses.add().binary_cross_entropy.SetInParent()
        if model_class == "DSSM":
            mc.metrics.add().recall_at_k.top_k = 1
        else:
            mc.metrics.add().auc.SetInParent()


def _convert_groups(src_mc: Node, mc, warnings: List[str]) -> None:
    from torcheasyrec_tpu_torch.protos import model_pb2

    for g in _many(src_mc, "feature_groups"):
        if isinstance(g, str):
            continue
        tz_g = mc.feature_groups.add()
        tz_g.group_name = _one(g, "group_name", "deep")
        wd = (_one(g, "wide_deep", "DEEP") or "DEEP").upper()
        tz_g.group_type = (
            model_pb2.FeatureGroupType.WIDE if wd == "WIDE"
            else model_pb2.FeatureGroupType.DEEP
        )
        for fn in _many(g, "feature_names"):
            tz_g.feature_names.append(fn)
        for sg in _many(g, "sequence_features"):
            if not isinstance(sg, dict):
                continue
            # EasyRec DIN-style sequence groups -> SEQUENCE group
            seq_g = mc.feature_groups.add()
            seq_g.group_name = _one(sg, "group_name",
                                    tz_g.group_name + "_seq")
            seq_g.group_type = model_pb2.FeatureGroupType.SEQUENCE
            for fm in _many(sg, "seq_att_map"):
                if isinstance(fm, dict):
                    for fn in _many(fm, "key") + _many(fm, "hist_seq"):
                        seq_g.feature_names.append(fn)


def _ensure_fm_group(pipeline, warnings: List[str]) -> None:
    """DeepFM's FM term needs equal embedding dims. TF-EasyRec mixes
    raw + id features in one 'deep' group (its FM skips non-embedded
    inputs internally); tzrec models take an explicit 'fm' group — so
    synthesize one from the deep group's embedded, modal-dim features
    (DeepFM's feature_groups contract)."""
    mc = pipeline.model_config
    if mc.WhichOneof("model") != "deepfm":
        return
    names = {g.group_name for g in mc.feature_groups}
    if "fm" in names:
        return
    deep = next(
        (g for g in mc.feature_groups if g.group_name == "deep"), None
    )
    if deep is None:
        return
    dims: Dict[str, int] = {}
    for fc in pipeline.feature_configs:
        f = getattr(fc, fc.WhichOneof("feature"))
        dim = int(getattr(f, "embedding_dim", 0) or 0)
        if dim:
            dims[f.feature_name] = dim
    embedded = [n for n in deep.feature_names if n in dims]
    if not embedded:
        return
    counts: Dict[int, int] = {}
    for n in embedded:
        counts[dims[n]] = counts.get(dims[n], 0) + 1
    modal = max(counts, key=lambda d: counts[d])
    keep = [n for n in embedded if dims[n] == modal]
    from torcheasyrec_tpu_torch.protos import model_pb2

    g = mc.feature_groups.add()
    g.group_name = "fm"
    g.group_type = model_pb2.FeatureGroupType.DEEP
    g.feature_names.extend(keep)
    dropped = [n for n in deep.feature_names if n not in keep]
    warnings.append(
        f"deepfm: synthesized 'fm' group from deep's dim-{modal} "
        f"embedded features {keep}"
        + (f"; excluded {dropped}" if dropped else "")
    )


# ------------------------------------------------------------------ main


def convert(text: str, fg_json: Optional[Dict[str, Any]] = None
            ) -> Tuple[str, List[str]]:
    from torcheasyrec_tpu_torch.protos import pipeline_pb2

    src = parse_text_proto(text)
    warnings: List[str] = []
    pipeline = pipeline_pb2.EasyRecConfig()

    for key in ("train_input_path", "eval_input_path", "model_dir"):
        v = _one(src, key)
        if v:
            setattr(pipeline, key, v)

    _convert_optimizer(_one(src, "train_config", {}), pipeline, warnings)
    pipeline.eval_config.SetInParent()

    dc = _one(src, "data_config", {})
    pipeline.data_config.batch_size = _as_int(
        _one(dc, "batch_size", 1024), 1024
    )
    from torcheasyrec_tpu_torch.protos import data_pb2

    pipeline.data_config.dataset_type = data_pb2.DatasetType.ParquetDataset
    pipeline.data_config.fg_mode = (
        data_pb2.FgMode.FG_NORMAL if fg_json else data_pb2.FgMode.FG_NONE
    )
    labels = _many(dc, "label_fields")
    if not labels:
        # fall back to task-tower labels
        mc_src = _one(src, "model_config", {})
        for bk in mc_src.values():
            for b in bk:
                if isinstance(b, dict):
                    for t in _many(b, "task_towers"):
                        lbl = _one(t, "label_name",
                                   _one(t, "label_fields"))
                        if lbl and lbl not in labels:
                            labels.append(lbl)
    pipeline.data_config.label_fields.extend(labels or ["label"])
    if _one(dc, "input_type") not in (None, "ParquetInput"):
        warnings.append(
            f"data_config.input_type {_one(dc, 'input_type')}: converted "
            "to ParquetDataset; re-export your data to parquet"
        )

    if fg_json:
        _features_from_fg_json(fg_json, pipeline, warnings)
    else:
        _features_from_easyrec(src, pipeline, warnings)

    src_mc = _one(src, "model_config", {})
    _convert_groups(src_mc, pipeline.model_config, warnings)
    _convert_model(src_mc, pipeline.model_config, warnings)
    _ensure_fm_group(pipeline, warnings)
    if _one(src_mc, "embedding_regularization") is not None:
        warnings.append(
            "embedding_regularization: apply weight_decay on the sparse "
            "optimizer instead"
        )

    return text_format.MessageToString(pipeline, as_utf8=True), warnings


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--easyrec_config_path", required=True)
    parser.add_argument("--output_tzrec_config_path", required=True)
    parser.add_argument("--fg_json_path",
                        help="pyfg fg.json to derive feature configs from")
    args = parser.parse_args()
    with open(args.easyrec_config_path) as f:
        text = f.read()
    fg = None
    if args.fg_json_path:
        with open(args.fg_json_path) as f:
            fg = json.load(f)
    converted, warns = convert(text, fg)
    with open(args.output_tzrec_config_path, "w") as f:
        f.write(converted)
    for w in warns:
        print(f"WARNING: {w}")
    print(f"wrote {args.output_tzrec_config_path}")
