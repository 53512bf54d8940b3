# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: torcheasyrec_tpu_torch/protos/pipeline.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()


from torcheasyrec_tpu_torch.protos import train_pb2 as torcheasyrec__tpu__torch_dot_protos_dot_train__pb2
from torcheasyrec_tpu_torch.protos import eval_pb2 as torcheasyrec__tpu__torch_dot_protos_dot_eval__pb2
from torcheasyrec_tpu_torch.protos import export_pb2 as torcheasyrec__tpu__torch_dot_protos_dot_export__pb2
from torcheasyrec_tpu_torch.protos import data_pb2 as torcheasyrec__tpu__torch_dot_protos_dot_data__pb2
from torcheasyrec_tpu_torch.protos import feature_pb2 as torcheasyrec__tpu__torch_dot_protos_dot_feature__pb2
from torcheasyrec_tpu_torch.protos import model_pb2 as torcheasyrec__tpu__torch_dot_protos_dot_model__pb2


DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n,torcheasyrec_tpu_torch/protos/pipeline.proto\x12\x16tzrec_tpu_torch.protos\x1a)torcheasyrec_tpu_torch/protos/train.proto\x1a(torcheasyrec_tpu_torch/protos/eval.proto\x1a*torcheasyrec_tpu_torch/protos/export.proto\x1a(torcheasyrec_tpu_torch/protos/data.proto\x1a+torcheasyrec_tpu_torch/protos/feature.proto\x1a)torcheasyrec_tpu_torch/protos/model.proto\"\xba\x03\n\rEasyRecConfig\x12\x18\n\x10train_input_path\x18\x01 \x02(\t\x12\x17\n\x0f\x65val_input_path\x18\x02 \x02(\t\x12\x11\n\tmodel_dir\x18\x03 \x02(\t\x12\x39\n\x0ctrain_config\x18\x04 \x01(\x0b\x32#.tzrec_tpu_torch.protos.TrainConfig\x12\x37\n\x0b\x65val_config\x18\x05 \x01(\x0b\x32\".tzrec_tpu_torch.protos.EvalConfig\x12;\n\rexport_config\x18\x06 \x01(\x0b\x32$.tzrec_tpu_torch.protos.ExportConfig\x12\x37\n\x0b\x64\x61ta_config\x18\x07 \x01(\x0b\x32\".tzrec_tpu_torch.protos.DataConfig\x12>\n\x0f\x66\x65\x61ture_configs\x18\x08 \x03(\x0b\x32%.tzrec_tpu_torch.protos.FeatureConfig\x12\x39\n\x0cmodel_config\x18\t \x01(\x0b\x32#.tzrec_tpu_torch.protos.ModelConfig')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'torcheasyrec_tpu_torch.protos.pipeline_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _EASYRECCONFIG._serialized_start=332
  _EASYRECCONFIG._serialized_end=774
# @@protoc_insertion_point(module_scope)
