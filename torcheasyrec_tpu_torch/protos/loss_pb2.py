# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: torcheasyrec_tpu_torch/protos/loss.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n(torcheasyrec_tpu_torch/protos/loss.proto\x12\x16tzrec_tpu_torch.protos\"0\n\x12\x42inaryCrossEntropy\x12\x1a\n\x0flabel_smoothing\x18\x01 \x01(\x02:\x01\x30\"1\n\x13SoftmaxCrossEntropy\x12\x1a\n\x0flabel_smoothing\x18\x01 \x01(\x02:\x01\x30\"\x08\n\x06L2Loss\"3\n\x07JRCLoss\x12\x14\n\x0csession_name\x18\x01 \x02(\t\x12\x12\n\x05\x61lpha\x18\x02 \x01(\x02:\x03\x30.5\"7\n\x0f\x42inaryFocalLoss\x12\x10\n\x05gamma\x18\x01 \x01(\x02:\x01\x32\x12\x12\n\x05\x61lpha\x18\x02 \x01(\x02:\x03\x30.5\"&\n\x0cSidReconLoss\x12\x16\n\nrecon_type\x18\x01 \x01(\t:\x02l2\"G\n\x11SidCommitmentLoss\x12\x15\n\rlatent_weight\x18\x01 \x03(\x02\x12\x1b\n\x0f\x63ommitment_type\x18\x02 \x01(\t:\x02l2\"\x14\n\x12SidContrastiveLoss\"\xb2\x04\n\nLossConfig\x12J\n\x14\x62inary_cross_entropy\x18\x01 \x01(\x0b\x32*.tzrec_tpu_torch.protos.BinaryCrossEntropyH\x00\x12L\n\x15softmax_cross_entropy\x18\x02 \x01(\x0b\x32+.tzrec_tpu_torch.protos.SoftmaxCrossEntropyH\x00\x12\x31\n\x07l2_loss\x18\x03 \x01(\x0b\x32\x1e.tzrec_tpu_torch.protos.L2LossH\x00\x12\x33\n\x08jrc_loss\x18\x04 \x01(\x0b\x32\x1f.tzrec_tpu_torch.protos.JRCLossH\x00\x12\x44\n\x11\x62inary_focal_loss\x18\x05 \x01(\x0b\x32\'.tzrec_tpu_torch.protos.BinaryFocalLossH\x00\x12:\n\nrecon_loss\x18\x06 \x01(\x0b\x32$.tzrec_tpu_torch.protos.SidReconLossH\x01\x12\x44\n\x0f\x63ommitment_loss\x18\x07 \x01(\x0b\x32).tzrec_tpu_torch.protos.SidCommitmentLossH\x01\x12\x46\n\x10\x63ontrastive_loss\x18\x08 \x01(\x0b\x32*.tzrec_tpu_torch.protos.SidContrastiveLossH\x01\x42\x06\n\x04lossB\n\n\x08sid_loss')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'torcheasyrec_tpu_torch.protos.loss_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _BINARYCROSSENTROPY._serialized_start=68
  _BINARYCROSSENTROPY._serialized_end=116
  _SOFTMAXCROSSENTROPY._serialized_start=118
  _SOFTMAXCROSSENTROPY._serialized_end=167
  _L2LOSS._serialized_start=169
  _L2LOSS._serialized_end=177
  _JRCLOSS._serialized_start=179
  _JRCLOSS._serialized_end=230
  _BINARYFOCALLOSS._serialized_start=232
  _BINARYFOCALLOSS._serialized_end=287
  _SIDRECONLOSS._serialized_start=289
  _SIDRECONLOSS._serialized_end=327
  _SIDCOMMITMENTLOSS._serialized_start=329
  _SIDCOMMITMENTLOSS._serialized_end=400
  _SIDCONTRASTIVELOSS._serialized_start=402
  _SIDCONTRASTIVELOSS._serialized_end=422
  _LOSSCONFIG._serialized_start=425
  _LOSSCONFIG._serialized_end=987
# @@protoc_insertion_point(module_scope)
