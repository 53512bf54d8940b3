# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: torcheasyrec_tpu_torch/protos/model.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()


from torcheasyrec_tpu_torch.protos import models_pb2 as torcheasyrec__tpu__torch_dot_protos_dot_models__pb2
from torcheasyrec_tpu_torch.protos import loss_pb2 as torcheasyrec__tpu__torch_dot_protos_dot_loss__pb2
from torcheasyrec_tpu_torch.protos import metric_pb2 as torcheasyrec__tpu__torch_dot_protos_dot_metric__pb2
from torcheasyrec_tpu_torch.protos import seq_encoder_pb2 as torcheasyrec__tpu__torch_dot_protos_dot_seq__encoder__pb2
from torcheasyrec_tpu_torch.protos import module_pb2 as torcheasyrec__tpu__torch_dot_protos_dot_module__pb2


DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n)torcheasyrec_tpu_torch/protos/model.proto\x12\x16tzrec_tpu_torch.protos\x1a*torcheasyrec_tpu_torch/protos/models.proto\x1a(torcheasyrec_tpu_torch/protos/loss.proto\x1a*torcheasyrec_tpu_torch/protos/metric.proto\x1a/torcheasyrec_tpu_torch/protos/seq_encoder.proto\x1a*torcheasyrec_tpu_torch/protos/module.proto\"Z\n\x0eSeqGroupConfig\x12\x12\n\ngroup_name\x18\x01 \x01(\t\x12\x15\n\rfeature_names\x18\x02 \x03(\t\x12\x1d\n\x15\x65mbedding_name_suffix\x18\x03 \x01(\t\"\xa8\x02\n\x12\x46\x65\x61tureGroupConfig\x12\x12\n\ngroup_name\x18\x01 \x02(\t\x12\x15\n\rfeature_names\x18\x02 \x03(\t\x12\x42\n\ngroup_type\x18\x03 \x02(\x0e\x32(.tzrec_tpu_torch.protos.FeatureGroupType:\x04\x44\x45\x45P\x12?\n\x0fsequence_groups\x18\x04 \x03(\x0b\x32&.tzrec_tpu_torch.protos.SeqGroupConfig\x12\x43\n\x11sequence_encoders\x18\x05 \x03(\x0b\x32(.tzrec_tpu_torch.protos.SeqEncoderConfig\x12\x1d\n\x15\x65mbedding_name_suffix\x18\x06 \x01(\t\"\xe9\x0e\n\x0bModelConfig\x12\x42\n\x0e\x66\x65\x61ture_groups\x18\x01 \x03(\x0b\x32*.tzrec_tpu_torch.protos.FeatureGroupConfig\x12,\n\x04\x64lrm\x18\x64 \x01(\x0b\x32\x1c.tzrec_tpu_torch.protos.DLRMH\x00\x12\x30\n\x06\x64\x65\x65pfm\x18\x65 \x01(\x0b\x32\x1e.tzrec_tpu_torch.protos.DeepFMH\x00\x12\x39\n\x0bmulti_tower\x18\x66 \x01(\x0b\x32\".tzrec_tpu_torch.protos.MultiTowerH\x00\x12@\n\x0fmulti_tower_din\x18g \x01(\x0b\x32%.tzrec_tpu_torch.protos.MultiTowerDINH\x00\x12\x33\n\x08mask_net\x18h \x01(\x0b\x32\x1f.tzrec_tpu_torch.protos.MaskNetH\x00\x12<\n\rwide_and_deep\x18i \x01(\x0b\x32#.tzrec_tpu_torch.protos.WideAndDeepH\x00\x12/\n\x06\x64\x63n_v1\x18j \x01(\x0b\x32\x1d.tzrec_tpu_torch.protos.DCNV1H\x00\x12/\n\x06\x64\x63n_v2\x18k \x01(\x0b\x32\x1d.tzrec_tpu_torch.protos.DCNV2H\x00\x12\x32\n\x07xdeepfm\x18l \x01(\x0b\x32\x1f.tzrec_tpu_torch.protos.xDeepFMH\x00\x12\x30\n\x06wukong\x18m \x01(\x0b\x32\x1e.tzrec_tpu_torch.protos.WuKongH\x00\x12\x45\n\x11simple_multi_task\x18\xc8\x01 \x01(\x0b\x32\'.tzrec_tpu_torch.protos.SimpleMultiTaskH\x00\x12-\n\x04mmoe\x18\xc9\x01 \x01(\x0b\x32\x1c.tzrec_tpu_torch.protos.MMoEH\x00\x12/\n\x05\x64\x62mtl\x18\xca\x01 \x01(\x0b\x32\x1d.tzrec_tpu_torch.protos.DBMTLH\x00\x12+\n\x03ple\x18\xcb\x01 \x01(\x0b\x32\x1b.tzrec_tpu_torch.protos.PLEH\x00\x12/\n\x05\x64\x63\x32vr\x18\xcc\x01 \x01(\x0b\x32\x1d.tzrec_tpu_torch.protos.DC2VRH\x00\x12\x36\n\tdlrm_hstu\x18\xcd\x01 \x01(\x0b\x32 .tzrec_tpu_torch.protos.DlrmHSTUH\x00\x12\x31\n\x06pepnet\x18\xce\x01 \x01(\x0b\x32\x1e.tzrec_tpu_torch.protos.PEPNetH\x00\x12\x38\n\nultra_hstu\x18\xcf\x01 \x01(\x0b\x32!.tzrec_tpu_torch.protos.UltraHSTUH\x00\x12-\n\x04\x64ssm\x18\xad\x02 \x01(\x0b\x32\x1c.tzrec_tpu_torch.protos.DSSMH\x00\x12\x32\n\x07\x64ssm_v2\x18\xae\x02 \x01(\x0b\x32\x1e.tzrec_tpu_torch.protos.DSSMV2H\x00\x12+\n\x03\x64\x61t\x18\xaf\x02 \x01(\x0b\x32\x1b.tzrec_tpu_torch.protos.DATH\x00\x12\x38\n\nhstu_match\x18\xb0\x02 \x01(\x0b\x32!.tzrec_tpu_torch.protos.HSTUMatchH\x00\x12-\n\x04mind\x18\xb1\x02 \x01(\x0b\x32\x1c.tzrec_tpu_torch.protos.MINDH\x00\x12+\n\x03tdm\x18\x90\x03 \x01(\x0b\x32\x1b.tzrec_tpu_torch.protos.TDMH\x00\x12\x44\n\x10rocket_launching\x18\xf4\x03 \x01(\x0b\x32\'.tzrec_tpu_torch.protos.RocketLaunchingH\x00\x12\x36\n\tsid_rqvae\x18\xd8\x04 \x01(\x0b\x32 .tzrec_tpu_torch.protos.SidRqvaeH\x00\x12<\n\x0csid_rqkmeans\x18\xd9\x04 \x01(\x0b\x32#.tzrec_tpu_torch.protos.SidRqkmeansH\x00\x12\x14\n\tnum_class\x18\x02 \x01(\r:\x01\x31\x12\x32\n\x06losses\x18\x03 \x03(\x0b\x32\".tzrec_tpu_torch.protos.LossConfig\x12\x35\n\x07metrics\x18\x04 \x03(\x0b\x32$.tzrec_tpu_torch.protos.MetricConfig\x12@\n\rtrain_metrics\x18\x05 \x03(\x0b\x32).tzrec_tpu_torch.protos.TrainMetricConfig\x12G\n\x13variational_dropout\x18\x0b \x01(\x0b\x32*.tzrec_tpu_torch.protos.VariationalDropout\x12\x36\n\x06kernel\x18\x0c \x01(\x0e\x32\x1e.tzrec_tpu_torch.protos.Kernel:\x06PALLAS\x12%\n\x16use_pareto_loss_weight\x18\r \x01(\x08:\x05\x66\x61lseB\x07\n\x05model*I\n\x10\x46\x65\x61tureGroupType\x12\x08\n\x04\x44\x45\x45P\x10\x00\x12\x08\n\x04WIDE\x10\x01\x12\x0c\n\x08SEQUENCE\x10\x02\x12\x13\n\x0fJAGGED_SEQUENCE\x10\x03*C\n\x06Kernel\x12\n\n\x06TRITON\x10\x00\x12\x0b\n\x07PYTORCH\x10\x01\x12\x0b\n\x07\x43UTLASS\x10\x02\x12\x07\n\x03JAX\x10\x03\x12\n\n\x06PALLAS\x10\x04')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'torcheasyrec_tpu_torch.protos.model_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _FEATUREGROUPTYPE._serialized_start=2583
  _FEATUREGROUPTYPE._serialized_end=2656
  _KERNEL._serialized_start=2658
  _KERNEL._serialized_end=2725
  _SEQGROUPCONFIG._serialized_start=292
  _SEQGROUPCONFIG._serialized_end=382
  _FEATUREGROUPCONFIG._serialized_start=385
  _FEATUREGROUPCONFIG._serialized_end=681
  _MODELCONFIG._serialized_start=684
  _MODELCONFIG._serialized_end=2581
# @@protoc_insertion_point(module_scope)
