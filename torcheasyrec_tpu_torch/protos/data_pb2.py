# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: torcheasyrec_tpu_torch/protos/data.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()


from torcheasyrec_tpu_torch.protos import sampler_pb2 as torcheasyrec__tpu__torch_dot_protos_dot_sampler__pb2


DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n(torcheasyrec_tpu_torch/protos/data.proto\x12\x16tzrec_tpu_torch.protos\x1a+torcheasyrec_tpu_torch/protos/sampler.proto\"R\n\x05\x46ield\x12\x12\n\ninput_name\x18\x01 \x02(\t\x12\x35\n\ninput_type\x18\x02 \x01(\x0e\x32!.tzrec_tpu_torch.protos.FieldType\"\xe7\t\n\nDataConfig\x12\x18\n\nbatch_size\x18\x01 \x01(\r:\x04\x31\x30\x32\x34\x12I\n\x0c\x64\x61taset_type\x18\x02 \x02(\x0e\x32#.tzrec_tpu_torch.protos.DatasetType:\x0eParquetDataset\x12\x18\n\nfg_encoded\x18\x03 \x01(\x08:\x04true\x12\"\n\x17\x66g_encoded_multival_sep\x18\x04 \x01(\t:\x01\x03\x12\x14\n\x0clabel_fields\x18\x05 \x03(\t\x12\x16\n\x0bnum_workers\x18\x06 \x01(\r:\x01\x38\x12\x18\n\npin_memory\x18\x07 \x01(\x08:\x04true\x12\x33\n\x0cinput_fields\x18\x08 \x03(\x0b\x32\x1d.tzrec_tpu_torch.protos.Field\x12\x14\n\tdelimiter\x18\t \x01(\t:\x01,\x12\x1a\n\x0bwith_header\x18\n \x01(\x08:\x05\x66\x61lse\x12\x17\n\x0f\x65val_batch_size\x18\x0b \x01(\r\x12\x1d\n\x0e\x64rop_remainder\x18\x0c \x01(\x08:\x05\x66\x61lse\x12\x15\n\nfg_threads\x18\r \x01(\r:\x01\x31\x12#\n\x14is_orderby_partition\x18\x0e \x01(\x08:\x05\x66\x61lse\x12+\n\x14odps_data_quota_name\x18\x0f \x01(\t:\rpay-as-you-go\x12\x1b\n\x10sample_mask_prob\x18\x10 \x01(\x02:\x01\x30\x12$\n\x19negative_sample_mask_prob\x18\x11 \x01(\x02:\x01\x30\x12$\n\x15\x66orce_base_data_group\x18\x12 \x01(\x08:\x05\x66\x61lse\x12\x1c\n\x14sample_weight_fields\x18\x13 \x03(\t\x12\x38\n\x07\x66g_mode\x18\x14 \x01(\x0e\x32\x1e.tzrec_tpu_torch.protos.FgMode:\x07\x46G_NONE\x12\x16\n\x07shuffle\x18\x16 \x01(\x08:\x05\x66\x61lse\x12\x1f\n\x13shuffle_buffer_size\x18\x17 \x01(\r:\x02\x33\x32\x12(\n\x15odps_data_compression\x18\x18 \x01(\t:\tLZ4_FRAME\x12\x19\n\x11sample_cost_field\x18\x19 \x01(\t\x12\x17\n\x0f\x62\x61tch_cost_size\x18\x1a \x01(\x04\x12\x18\n\x10input_fields_str\x18\x1b \x01(\t\x12\x43\n\x10negative_sampler\x18\x65 \x01(\x0b\x32\'.tzrec_tpu_torch.protos.NegativeSamplerH\x00\x12H\n\x13negative_sampler_v2\x18\x66 \x01(\x0b\x32).tzrec_tpu_torch.protos.NegativeSamplerV2H\x00\x12L\n\x15hard_negative_sampler\x18g \x01(\x0b\x32+.tzrec_tpu_torch.protos.HardNegativeSamplerH\x00\x12Q\n\x18hard_negative_sampler_v2\x18h \x01(\x0b\x32-.tzrec_tpu_torch.protos.HardNegativeSamplerV2H\x00\x12\x39\n\x0btdm_sampler\x18i \x01(\x0b\x32\".tzrec_tpu_torch.protos.TDMSamplerH\x00\x42\t\n\x07sampler*g\n\x0b\x44\x61tasetType\x12\x0f\n\x0bOdpsDataset\x10\x01\x12\x12\n\x0eParquetDataset\x10\x02\x12\x0e\n\nCsvDataset\x10\x03\x12\x11\n\rOdpsDatasetV1\x10\x04\x12\x10\n\x0cKafkaDataset\x10\x05*\xd6\x04\n\tFieldType\x12\t\n\x05INT32\x10\x00\x12\t\n\x05INT64\x10\x01\x12\n\n\x06STRING\x10\x02\x12\t\n\x05\x46LOAT\x10\x03\x12\n\n\x06\x44OUBLE\x10\x04\x12\x0f\n\x0b\x41RRAY_INT32\x10\x05\x12\x0f\n\x0b\x41RRAY_INT64\x10\x06\x12\x10\n\x0c\x41RRAY_STRING\x10\x07\x12\x0f\n\x0b\x41RRAY_FLOAT\x10\x08\x12\x10\n\x0c\x41RRAY_DOUBLE\x10\t\x12\x15\n\x11\x41RRAY_ARRAY_INT32\x10\n\x12\x15\n\x11\x41RRAY_ARRAY_INT64\x10\x0b\x12\x16\n\x12\x41RRAY_ARRAY_STRING\x10\x0c\x12\x15\n\x11\x41RRAY_ARRAY_FLOAT\x10\r\x12\x16\n\x12\x41RRAY_ARRAY_DOUBLE\x10\x0e\x12\x14\n\x10MAP_STRING_INT32\x10\x0f\x12\x14\n\x10MAP_STRING_INT64\x10\x10\x12\x15\n\x11MAP_STRING_STRING\x10\x11\x12\x14\n\x10MAP_STRING_FLOAT\x10\x12\x12\x15\n\x11MAP_STRING_DOUBLE\x10\x13\x12\x13\n\x0fMAP_INT64_INT32\x10\x14\x12\x13\n\x0fMAP_INT64_INT64\x10\x15\x12\x14\n\x10MAP_INT64_STRING\x10\x16\x12\x13\n\x0fMAP_INT64_FLOAT\x10\x17\x12\x14\n\x10MAP_INT64_DOUBLE\x10\x18\x12\x13\n\x0fMAP_INT32_INT32\x10\x19\x12\x13\n\x0fMAP_INT32_INT64\x10\x1a\x12\x14\n\x10MAP_INT32_STRING\x10\x1b\x12\x13\n\x0fMAP_INT32_FLOAT\x10\x1c\x12\x14\n\x10MAP_INT32_DOUBLE\x10\x1d*B\n\x06\x46gMode\x12\x0b\n\x07\x46G_NONE\x10\x01\x12\r\n\tFG_NORMAL\x10\x02\x12\n\n\x06\x46G_DAG\x10\x03\x12\x10\n\x0c\x46G_BUCKETIZE\x10\x04')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'torcheasyrec_tpu_torch.protos.data_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _DATASETTYPE._serialized_start=1455
  _DATASETTYPE._serialized_end=1558
  _FIELDTYPE._serialized_start=1561
  _FIELDTYPE._serialized_end=2159
  _FGMODE._serialized_start=2161
  _FGMODE._serialized_end=2227
  _FIELD._serialized_start=113
  _FIELD._serialized_end=195
  _DATACONFIG._serialized_start=198
  _DATACONFIG._serialized_end=1453
# @@protoc_insertion_point(module_scope)
