# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: torcheasyrec_tpu_torch/protos/seq_encoder.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()


from torcheasyrec_tpu_torch.protos import module_pb2 as torcheasyrec__tpu__torch_dot_protos_dot_module__pb2


DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n/torcheasyrec_tpu_torch/protos/seq_encoder.proto\x12\x16tzrec_tpu_torch.protos\x1a*torcheasyrec_tpu_torch/protos/module.proto\"s\n\nDINEncoder\x12\x0c\n\x04name\x18\x01 \x01(\t\x12\r\n\x05input\x18\x02 \x02(\t\x12-\n\x08\x61ttn_mlp\x18\x03 \x02(\x0b\x32\x1b.tzrec_tpu_torch.protos.MLP\x12\x19\n\x0emax_seq_length\x18\x06 \x01(\x05:\x01\x30\"I\n\x0fSimpleAttention\x12\x0c\n\x04name\x18\x01 \x01(\t\x12\r\n\x05input\x18\x02 \x02(\t\x12\x19\n\x0emax_seq_length\x18\x06 \x01(\x05:\x01\x30\"d\n\x0ePoolingEncoder\x12\x0c\n\x04name\x18\x01 \x01(\t\x12\r\n\x05input\x18\x02 \x02(\t\x12\x1a\n\x0cpooling_type\x18\x03 \x01(\t:\x04mean\x12\x19\n\x0emax_seq_length\x18\x06 \x01(\x05:\x01\x30\"\x99\x01\n\x14SelfAttentionEncoder\x12\x0c\n\x04name\x18\x01 \x01(\t\x12\r\n\x05input\x18\x02 \x02(\t\x12\x1f\n\x12multihead_attn_dim\x18\x03 \x01(\x05:\x03\x35\x31\x32\x12\x14\n\tnum_heads\x18\x04 \x01(\x05:\x01\x38\x12\x12\n\x07\x64ropout\x18\x05 \x01(\x02:\x01\x30\x12\x19\n\x0emax_seq_length\x18\x06 \x01(\x05:\x01\x30\"x\n\x15MultiWindowDINEncoder\x12\x0c\n\x04name\x18\x01 \x01(\t\x12\r\n\x05input\x18\x02 \x02(\t\x12-\n\x08\x61ttn_mlp\x18\x03 \x02(\x0b\x32\x1b.tzrec_tpu_torch.protos.MLP\x12\x13\n\x0bwindows_len\x18\x04 \x03(\r\"\x86\x03\n\x10SeqEncoderConfig\x12\x39\n\x0b\x64in_encoder\x18\x01 \x01(\x0b\x32\".tzrec_tpu_torch.protos.DINEncoderH\x00\x12\x43\n\x10simple_attention\x18\x02 \x01(\x0b\x32\'.tzrec_tpu_torch.protos.SimpleAttentionH\x00\x12\x41\n\x0fpooling_encoder\x18\x03 \x01(\x0b\x32&.tzrec_tpu_torch.protos.PoolingEncoderH\x00\x12Q\n\x18multi_window_din_encoder\x18\x04 \x01(\x0b\x32-.tzrec_tpu_torch.protos.MultiWindowDINEncoderH\x00\x12N\n\x16self_attention_encoder\x18\x06 \x01(\x0b\x32,.tzrec_tpu_torch.protos.SelfAttentionEncoderH\x00\x42\x0c\n\nseq_module')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'torcheasyrec_tpu_torch.protos.seq_encoder_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _DINENCODER._serialized_start=119
  _DINENCODER._serialized_end=234
  _SIMPLEATTENTION._serialized_start=236
  _SIMPLEATTENTION._serialized_end=309
  _POOLINGENCODER._serialized_start=311
  _POOLINGENCODER._serialized_end=411
  _SELFATTENTIONENCODER._serialized_start=414
  _SELFATTENTIONENCODER._serialized_end=567
  _MULTIWINDOWDINENCODER._serialized_start=569
  _MULTIWINDOWDINENCODER._serialized_end=689
  _SEQENCODERCONFIG._serialized_start=692
  _SEQENCODERCONFIG._serialized_end=1082
# @@protoc_insertion_point(module_scope)
