# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: torcheasyrec_tpu_torch/protos/metric.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n*torcheasyrec_tpu_torch/protos/metric.proto\x12\x16tzrec_tpu_torch.protos\"\x1e\n\x03\x41UC\x12\x17\n\nthresholds\x18\x01 \x01(\r:\x03\x32\x30\x30\"@\n\rMulticlassAUC\x12\x17\n\nthresholds\x18\x01 \x01(\r:\x03\x32\x30\x30\x12\x16\n\x07\x61verage\x18\x02 \x01(\t:\x05macro\"\x1d\n\tRecallAtK\x12\x10\n\x05top_k\x18\x01 \x01(\r:\x01\x35\"\x13\n\x11MeanAbsoluteError\"\x12\n\x10MeanSquaredError\"4\n\x08\x41\x63\x63uracy\x12\x16\n\tthreshold\x18\x01 \x01(\x02:\x03\x30.5\x12\x10\n\x05top_k\x18\x02 \x01(\r:\x01\x31\"\"\n\nGroupedAUC\x12\x14\n\x0cgrouping_key\x18\x01 \x02(\t\"O\n\x04XAUC\x12\x1b\n\x0csample_ratio\x18\x01 \x01(\x02:\x05\x30.001\x12\x11\n\tmax_pairs\x18\x02 \x01(\x04\x12\x17\n\x08in_batch\x18\x03 \x01(\x08:\x05\x66\x61lse\"E\n\x0bGroupedXAUC\x12\x14\n\x0cgrouping_key\x18\x01 \x02(\t\x12 \n\x13max_pairs_per_group\x18\x02 \x01(\x04:\x03\x31\x30\x30\"\'\n\x11NormalizedEntropy\x12\x12\n\x03\x65ta\x18\x01 \x01(\x02:\x05\x31\x65-12\"\xf6\x04\n\x0cMetricConfig\x12*\n\x03\x61uc\x18\x01 \x01(\x0b\x32\x1b.tzrec_tpu_torch.protos.AUCH\x00\x12?\n\x0emulticlass_auc\x18\x02 \x01(\x0b\x32%.tzrec_tpu_torch.protos.MulticlassAUCH\x00\x12\x38\n\x0brecall_at_k\x18\x03 \x01(\x0b\x32!.tzrec_tpu_torch.protos.RecallAtKH\x00\x12H\n\x13mean_absolute_error\x18\x04 \x01(\x0b\x32).tzrec_tpu_torch.protos.MeanAbsoluteErrorH\x00\x12\x46\n\x12mean_squared_error\x18\x05 \x01(\x0b\x32(.tzrec_tpu_torch.protos.MeanSquaredErrorH\x00\x12\x34\n\x08\x61\x63\x63uracy\x18\x06 \x01(\x0b\x32 .tzrec_tpu_torch.protos.AccuracyH\x00\x12\x39\n\x0bgrouped_auc\x18\x07 \x01(\x0b\x32\".tzrec_tpu_torch.protos.GroupedAUCH\x00\x12,\n\x04xauc\x18\x08 \x01(\x0b\x32\x1c.tzrec_tpu_torch.protos.XAUCH\x00\x12;\n\x0cgrouped_xauc\x18\t \x01(\x0b\x32#.tzrec_tpu_torch.protos.GroupedXAUCH\x00\x12G\n\x12normalized_entropy\x18\n \x01(\x0b\x32).tzrec_tpu_torch.protos.NormalizedEntropyH\x00\x42\x08\n\x06metric\"\xab\x03\n\x11TrainMetricConfig\x12*\n\x03\x61uc\x18\x01 \x01(\x0b\x32\x1b.tzrec_tpu_torch.protos.AUCH\x00\x12\x38\n\x0brecall_at_k\x18\x03 \x01(\x0b\x32!.tzrec_tpu_torch.protos.RecallAtKH\x00\x12H\n\x13mean_absolute_error\x18\x04 \x01(\x0b\x32).tzrec_tpu_torch.protos.MeanAbsoluteErrorH\x00\x12\x46\n\x12mean_squared_error\x18\x05 \x01(\x0b\x32(.tzrec_tpu_torch.protos.MeanSquaredErrorH\x00\x12\x34\n\x08\x61\x63\x63uracy\x18\x06 \x01(\x0b\x32 .tzrec_tpu_torch.protos.AccuracyH\x00\x12,\n\x04xauc\x18\x08 \x01(\x0b\x32\x1c.tzrec_tpu_torch.protos.XAUCH\x00\x12\x17\n\ndecay_rate\x18\x14 \x01(\x02:\x03\x30.9\x12\x17\n\ndecay_step\x18\x15 \x01(\r:\x03\x31\x30\x30\x42\x08\n\x06metric')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'torcheasyrec_tpu_torch.protos.metric_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _AUC._serialized_start=70
  _AUC._serialized_end=100
  _MULTICLASSAUC._serialized_start=102
  _MULTICLASSAUC._serialized_end=166
  _RECALLATK._serialized_start=168
  _RECALLATK._serialized_end=197
  _MEANABSOLUTEERROR._serialized_start=199
  _MEANABSOLUTEERROR._serialized_end=218
  _MEANSQUAREDERROR._serialized_start=220
  _MEANSQUAREDERROR._serialized_end=238
  _ACCURACY._serialized_start=240
  _ACCURACY._serialized_end=292
  _GROUPEDAUC._serialized_start=294
  _GROUPEDAUC._serialized_end=328
  _XAUC._serialized_start=330
  _XAUC._serialized_end=409
  _GROUPEDXAUC._serialized_start=411
  _GROUPEDXAUC._serialized_end=480
  _NORMALIZEDENTROPY._serialized_start=482
  _NORMALIZEDENTROPY._serialized_end=521
  _METRICCONFIG._serialized_start=524
  _METRICCONFIG._serialized_end=1154
  _TRAINMETRICCONFIG._serialized_start=1157
  _TRAINMETRICCONFIG._serialized_end=1584
# @@protoc_insertion_point(module_scope)
