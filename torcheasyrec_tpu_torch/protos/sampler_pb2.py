# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: torcheasyrec_tpu_torch/protos/sampler.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n+torcheasyrec_tpu_torch/protos/sampler.proto\x12\x16tzrec_tpu_torch.protos\"\xcf\x01\n\x0fNegativeSampler\x12\x12\n\ninput_path\x18\x01 \x02(\t\x12\x12\n\nnum_sample\x18\x02 \x02(\r\x12\x13\n\x0b\x61ttr_fields\x18\x03 \x03(\t\x12\x15\n\ritem_id_field\x18\x04 \x02(\t\x12\x19\n\x0e\x61ttr_delimiter\x18\x05 \x01(\t:\x01:\x12\x1a\n\x0fnum_eval_sample\x18\x06 \x01(\r:\x01\x30\x12\x17\n\x0f\x66ield_delimiter\x18\x07 \x01(\t\x12\x18\n\ritem_id_delim\x18\x08 \x01(\t:\x01;\"\x89\x02\n\x11NegativeSamplerV2\x12\x17\n\x0fuser_input_path\x18\x01 \x02(\t\x12\x17\n\x0fitem_input_path\x18\x02 \x02(\t\x12\x1b\n\x13pos_edge_input_path\x18\x03 \x02(\t\x12\x12\n\nnum_sample\x18\x04 \x02(\r\x12\x13\n\x0b\x61ttr_fields\x18\x05 \x03(\t\x12\x15\n\ritem_id_field\x18\x06 \x02(\t\x12\x15\n\ruser_id_field\x18\x07 \x02(\t\x12\x19\n\x0e\x61ttr_delimiter\x18\x08 \x01(\t:\x01:\x12\x1a\n\x0fnum_eval_sample\x18\t \x01(\r:\x01\x30\x12\x17\n\x0f\x66ield_delimiter\x18\n \x01(\t\"\xa9\x02\n\x13HardNegativeSampler\x12\x17\n\x0fuser_input_path\x18\x01 \x02(\t\x12\x17\n\x0fitem_input_path\x18\x02 \x02(\t\x12 \n\x18hard_neg_edge_input_path\x18\x03 \x02(\t\x12\x12\n\nnum_sample\x18\x04 \x02(\r\x12\x17\n\x0fnum_hard_sample\x18\x05 \x02(\r\x12\x13\n\x0b\x61ttr_fields\x18\x06 \x03(\t\x12\x15\n\ritem_id_field\x18\x07 \x02(\t\x12\x15\n\ruser_id_field\x18\x08 \x02(\t\x12\x19\n\x0e\x61ttr_delimiter\x18\t \x01(\t:\x01:\x12\x1a\n\x0fnum_eval_sample\x18\n \x01(\r:\x01\x30\x12\x17\n\x0f\x66ield_delimiter\x18\x0b \x01(\t\"\xc8\x02\n\x15HardNegativeSamplerV2\x12\x17\n\x0fuser_input_path\x18\x01 \x02(\t\x12\x17\n\x0fitem_input_path\x18\x02 \x02(\t\x12\x1b\n\x13pos_edge_input_path\x18\x03 \x02(\t\x12 \n\x18hard_neg_edge_input_path\x18\x04 \x02(\t\x12\x12\n\nnum_sample\x18\x05 \x02(\r\x12\x17\n\x0fnum_hard_sample\x18\x06 \x02(\r\x12\x13\n\x0b\x61ttr_fields\x18\x07 \x03(\t\x12\x15\n\ritem_id_field\x18\x08 \x02(\t\x12\x15\n\ruser_id_field\x18\t \x02(\t\x12\x19\n\x0e\x61ttr_delimiter\x18\n \x01(\t:\x01:\x12\x1a\n\x0fnum_eval_sample\x18\x0b \x01(\r:\x01\x30\x12\x17\n\x0f\x66ield_delimiter\x18\x0c \x01(\t\"\xb1\x02\n\nTDMSampler\x12\x17\n\x0fitem_input_path\x18\x01 \x02(\t\x12\x17\n\x0f\x65\x64ge_input_path\x18\x02 \x02(\t\x12\x1f\n\x17predict_edge_input_path\x18\x03 \x02(\t\x12\x13\n\x0b\x61ttr_fields\x18\x04 \x03(\t\x12\x15\n\ritem_id_field\x18\x05 \x02(\t\x12\x18\n\x10layer_num_sample\x18\x06 \x03(\r\x12\x19\n\x0e\x61ttr_delimiter\x18\x07 \x01(\t:\x01:\x12\x1a\n\x0fnum_eval_sample\x18\x08 \x01(\r:\x01\x30\x12\x17\n\x0f\x66ield_delimiter\x18\t \x01(\t\x12\x17\n\x0cremain_ratio\x18\n \x01(\x02:\x01\x31\x12!\n\x10probability_type\x18\x0b \x01(\t:\x07UNIFORM')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'torcheasyrec_tpu_torch.protos.sampler_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _NEGATIVESAMPLER._serialized_start=72
  _NEGATIVESAMPLER._serialized_end=279
  _NEGATIVESAMPLERV2._serialized_start=282
  _NEGATIVESAMPLERV2._serialized_end=547
  _HARDNEGATIVESAMPLER._serialized_start=550
  _HARDNEGATIVESAMPLER._serialized_end=847
  _HARDNEGATIVESAMPLERV2._serialized_start=850
  _HARDNEGATIVESAMPLERV2._serialized_end=1178
  _TDMSAMPLER._serialized_start=1181
  _TDMSAMPLER._serialized_end=1486
# @@protoc_insertion_point(module_scope)
