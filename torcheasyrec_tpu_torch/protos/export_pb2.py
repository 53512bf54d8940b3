# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: torcheasyrec_tpu_torch/protos/export.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n*torcheasyrec_tpu_torch/protos/export.proto\x12\x16tzrec_tpu_torch.protos\"\xd9\x01\n\x0c\x45xportConfig\x12\x1d\n\rexporter_type\x18\x01 \x01(\t:\x06latest\x12!\n\x14\x62\x65st_exporter_metric\x18\x02 \x01(\t:\x03\x61uc\x12%\n\x17metric_larger_is_better\x18\x03 \x01(\x08:\x04true\x12\x19\n\x0fmixed_precision\x18\x04 \x01(\t:\x00\x12\x1e\n\x10\x63udnn_allow_tf32\x18\x05 \x01(\x08:\x04true\x12%\n\x16\x63uda_matmul_allow_tf32\x18\x06 \x01(\x08:\x05\x66\x61lse')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'torcheasyrec_tpu_torch.protos.export_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _EXPORTCONFIG._serialized_start=71
  _EXPORTCONFIG._serialized_end=288
# @@protoc_insertion_point(module_scope)
