"""Pipeline-config loading.

Counterpart of torcheasyrec_tpu/utils/config_util.py
(load_pipeline_config, config_to_kwargs). The text-format EasyRecConfig
is the user-facing surface: the same text parses into this package's
protos and into the JAX package's, since text format names no package.
protobuf is imported inside the functions, so the model code can be
built from keyword arguments alone.
"""

from typing import Any, Dict


def load_pipeline_config(pipeline_config_path: str,
                         allow_unknown_field: bool = False):
    """Load an EasyRecConfig from a text-format (or json) file."""
    with open(pipeline_config_path) as f:
        return parse_pipeline_config(
            f.read(), is_json=pipeline_config_path.endswith(".json"),
            allow_unknown_field=allow_unknown_field,
        )


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
