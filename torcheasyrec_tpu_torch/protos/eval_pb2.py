# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: torcheasyrec_tpu_torch/protos/eval.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n(torcheasyrec_tpu_torch/protos/eval.proto\x12\x16tzrec_tpu_torch.protos\"A\n\nEvalConfig\x12\x11\n\tnum_steps\x18\x01 \x01(\r\x12 \n\x14log_step_count_steps\x18\x02 \x01(\r:\x02\x31\x30')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'torcheasyrec_tpu_torch.protos.eval_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _EVALCONFIG._serialized_start=68
  _EVALCONFIG._serialized_end=133
# @@protoc_insertion_point(module_scope)
