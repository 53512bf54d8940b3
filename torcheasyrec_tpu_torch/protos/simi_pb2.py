# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: torcheasyrec_tpu_torch/protos/simi.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n(torcheasyrec_tpu_torch/protos/simi.proto\x12\x16tzrec_tpu_torch.protos*7\n\nSimilarity\x12\n\n\x06\x43OSINE\x10\x00\x12\x11\n\rINNER_PRODUCT\x10\x01\x12\n\n\x06\x45UCLID\x10\x02')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'torcheasyrec_tpu_torch.protos.simi_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _SIMILARITY._serialized_start=68
  _SIMILARITY._serialized_end=123
# @@protoc_insertion_point(module_scope)
