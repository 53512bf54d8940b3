"""Pipeline-config loading and editing.

Counterpart of torcheasyrec_tpu/utils/config_util.py
(load_pipeline_config, save_message, config_to_kwargs, edit_config).
The text-format
EasyRecConfig is the user-facing surface: the same text parses into this package's
protos and into the JAX package's, since text format names no package.
protobuf is imported inside the functions, so the model code can be
built from keyword arguments alone.
"""

import os
import re
from typing import Any, Dict


def load_pipeline_config(pipeline_config_path: str,
                         allow_unknown_field: bool = False):
    """Load an EasyRecConfig from a text-format (or json) file."""
    with open(pipeline_config_path) as f:
        return parse_pipeline_config(
            f.read(), is_json=pipeline_config_path.endswith(".json"),
            allow_unknown_field=allow_unknown_field,
        )


def save_message(message, filepath: str) -> None:
    """Write a proto message as text format (the directory is made)."""
    from google.protobuf import text_format

    directory = os.path.dirname(filepath)
    if directory:
        os.makedirs(directory, exist_ok=True)
    with open(filepath, "w") as f:
        f.write(text_format.MessageToString(message, as_utf8=True))


def parse_pipeline_config(text: str, is_json: bool = False,
                          allow_unknown_field: bool = False):
    """Parse EasyRecConfig text (text format, or json if ``is_json``)."""
    from google.protobuf import json_format, text_format

    from torcheasyrec_tpu_torch.protos import pipeline_pb2

    config = pipeline_pb2.EasyRecConfig()
    if is_json:
        json_format.Parse(text, config,
                          ignore_unknown_fields=allow_unknown_field)
    else:
        text_format.Merge(text, config,
                          allow_unknown_field=allow_unknown_field)
    config.data_config.fg_mode = _get_compatible_fg_mode(config.data_config)
    return config


def _get_compatible_fg_mode(data_config) -> int:
    """Map the deprecated fg_encoded flag to FgMode."""
    from torcheasyrec_tpu_torch.protos.data_pb2 import FgMode

    if data_config.HasField("fg_encoded"):
        if data_config.HasField("fg_mode"):
            return data_config.fg_mode
        return FgMode.FG_NONE if data_config.fg_encoded else FgMode.FG_NORMAL
    return data_config.fg_mode


def config_to_kwargs(config) -> Dict[str, Any]:
    """Convert a message to a plain dict (proto field names preserved)."""
    from google.protobuf import json_format

    return json_format.MessageToDict(
        config,
        always_print_fields_with_no_presence=True,
        preserving_proto_field_name=True,
    )


_ARRAY_INDEX_RE = re.compile(r"(?P<name>[^\[\]]+)(\[(?P<index>.+)\])?")


def _resolve_attr(obj: Any, attr: str):
    """Resolve one path segment (possibly with [index] / [cond] suffix)."""
    m = _ARRAY_INDEX_RE.fullmatch(attr)
    name, index = m.group("name"), m.group("index")
    target = getattr(obj, name)
    if index is None:
        return [(obj, name, None)]
    # numeric index or slice a:b
    if re.fullmatch(r"-?\d+", index):
        return [(target, None, int(index))]
    if re.fullmatch(r"-?\d*:-?\d*", index):
        lo, hi = index.split(":")
        lo = int(lo) if lo else 0
        hi = int(hi) if hi else len(target)
        return [(target, None, i) for i in range(lo, hi)]
    # condition like feature_name=xyz or >=, <=, etc.
    cm = re.fullmatch(r"(?P<key>\w+)\s*(?P<op>>=|<=|=|>|<)\s*(?P<val>.+)", index)
    if cm is None:
        raise ValueError(f"cannot parse config path index [{index}]")
    key, op, val = cm.group("key"), cm.group("op"), cm.group("val")
    out = []
    for i, elem in enumerate(target):
        # elements may be oneof wrappers; search one level down too
        candidates = [elem]
        for _, sub in type(elem).DESCRIPTOR.oneofs_by_name.items():
            which = elem.WhichOneof(sub.name)
            if which is not None:
                candidates.append(getattr(elem, which))
        for c in candidates:
            if not hasattr(c, key):
                continue
            cur = getattr(c, key)
            try:
                ref = type(cur)(val)
            except (TypeError, ValueError):
                ref = val
            ok = {
                "=": cur == ref,
                ">": cur > ref,
                "<": cur < ref,
                ">=": cur >= ref,
                "<=": cur <= ref,
            }[op]
            if ok:
                out.append((target, None, i))
                break
    return out


def _set_leaf(parent: Any, name: str, index, value_str: str) -> None:
    from google.protobuf import text_format
    from google.protobuf.message import Message

    if name is not None:
        cur = getattr(parent, name)
    else:
        cur = parent[index]
    if isinstance(cur, Message):
        text_format.Merge(value_str, cur)
        return
    if isinstance(cur, bool):
        value = value_str.strip().lower() in ("true", "1", "yes")
    elif isinstance(cur, (int, float)):
        try:
            value = type(cur)(value_str)
        except ValueError:
            # enum set by NAME (e.g. dataset_type: "ParquetDataset")
            if name is not None and isinstance(parent, Message):
                fd = parent.DESCRIPTOR.fields_by_name.get(name)
                if fd is not None and fd.enum_type is not None:
                    value = fd.enum_type.values_by_name[
                        value_str.strip()
                    ].number
                else:
                    raise
            else:
                raise
    elif isinstance(cur, str):
        value = value_str
    else:
        # repeated scalar field: replace contents
        try:
            elems = [type(cur[0])(v) if len(cur) else float(v) for v in
                     re.split(r"[,\s]+", value_str.strip().strip("[]")) if v]
            del cur[:]
            cur.extend(elems)
            return
        except Exception as e:  # noqa: BLE001
            raise ValueError(f"cannot assign {value_str!r}") from e
    if name is not None:
        setattr(parent, name, value)
    else:
        parent[index] = value


def edit_config(pipeline_config, edits: Dict[str, str]):
    """Apply path edits to ``pipeline_config`` in place (the JAX
    package's ``edit_config``; the form of ``edit_config_json``).

    Paths look like ``train_config.num_steps`` or
    ``feature_configs[feature_name=cat_0].id_feature.embedding_dim`` or
    ``feature_configs[0].raw_feature.boundaries``.
    """
    for path, value in edits.items():
        segments = path.split(".")
        targets = [pipeline_config]
        for seg_i, seg in enumerate(segments):
            is_last = seg_i == len(segments) - 1
            new_targets = []
            for tgt in targets:
                resolved = _resolve_attr(tgt, seg)
                if is_last:
                    for parent, name, index in resolved:
                        _set_leaf(parent, name, index, str(value))
                else:
                    for parent, name, index in resolved:
                        new_targets.append(
                            getattr(parent, name) if name is not None
                            else parent[index]
                        )
            targets = new_targets
    return pipeline_config
