# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: torcheasyrec_tpu_torch/protos/tower.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()


from torcheasyrec_tpu_torch.protos import module_pb2 as torcheasyrec__tpu__torch_dot_protos_dot_module__pb2
from torcheasyrec_tpu_torch.protos import loss_pb2 as torcheasyrec__tpu__torch_dot_protos_dot_loss__pb2
from torcheasyrec_tpu_torch.protos import metric_pb2 as torcheasyrec__tpu__torch_dot_protos_dot_metric__pb2


DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n)torcheasyrec_tpu_torch/protos/tower.proto\x12\x16tzrec_tpu_torch.protos\x1a*torcheasyrec_tpu_torch/protos/module.proto\x1a(torcheasyrec_tpu_torch/protos/loss.proto\x1a*torcheasyrec_tpu_torch/protos/metric.proto\"@\n\x05Tower\x12\r\n\x05input\x18\x01 \x02(\t\x12(\n\x03mlp\x18\x02 \x01(\x0b\x32\x1b.tzrec_tpu_torch.protos.MLP\"_\n\rHSTUUserTower\x12\r\n\x05input\x18\x01 \x02(\t\x12*\n\x04hstu\x18\x02 \x02(\x0b\x32\x1c.tzrec_tpu_torch.protos.HSTU\x12\x13\n\x0bmax_seq_len\x18\x03 \x02(\r\"H\n\x08\x44INTower\x12\r\n\x05input\x18\x01 \x02(\t\x12-\n\x08\x61ttn_mlp\x18\x02 \x02(\x0b\x32\x1b.tzrec_tpu_torch.protos.MLP\"\xd9\x03\n\tTaskTower\x12\x12\n\ntower_name\x18\x01 \x02(\t\x12\x12\n\nlabel_name\x18\x02 \x01(\t\x12\x35\n\x07metrics\x18\x03 \x03(\x0b\x32$.tzrec_tpu_torch.protos.MetricConfig\x12@\n\rtrain_metrics\x18\x14 \x03(\x0b\x32).tzrec_tpu_torch.protos.TrainMetricConfig\x12\x32\n\x06losses\x18\x04 \x03(\x0b\x32\".tzrec_tpu_torch.protos.LossConfig\x12\x14\n\tnum_class\x18\x05 \x01(\r:\x01\x31\x12(\n\x03mlp\x18\x06 \x01(\x0b\x32\x1b.tzrec_tpu_torch.protos.MLP\x12\x11\n\x06weight\x18\x07 \x01(\x02:\x01\x31\x12\x1a\n\x12sample_weight_name\x18\x08 \x01(\t\x12\"\n\x1atask_space_indicator_label\x18\t \x01(\t\x12\x1f\n\x14in_task_space_weight\x18\n \x01(\x02:\x01\x31\x12 \n\x15out_task_space_weight\x18\x0b \x01(\x02:\x01\x31\x12!\n\x16pareto_min_loss_weight\x18\x0c \x01(\x02:\x01\x30\"\xaf\x04\n\x0e\x42\x61yesTaskTower\x12\x12\n\ntower_name\x18\x01 \x02(\t\x12\x12\n\nlabel_name\x18\x02 \x01(\t\x12\x35\n\x07metrics\x18\x03 \x03(\x0b\x32$.tzrec_tpu_torch.protos.MetricConfig\x12@\n\rtrain_metrics\x18\x14 \x03(\x0b\x32).tzrec_tpu_torch.protos.TrainMetricConfig\x12\x32\n\x06losses\x18\x04 \x03(\x0b\x32\".tzrec_tpu_torch.protos.LossConfig\x12\x14\n\tnum_class\x18\x05 \x01(\r:\x01\x31\x12(\n\x03mlp\x18\x06 \x01(\x0b\x32\x1b.tzrec_tpu_torch.protos.MLP\x12\x11\n\x06weight\x18\x07 \x01(\x02:\x01\x31\x12\x1c\n\x14relation_tower_names\x18\x08 \x03(\t\x12\x31\n\x0crelation_mlp\x18\t \x01(\x0b\x32\x1b.tzrec_tpu_torch.protos.MLP\x12\x1a\n\x12sample_weight_name\x18\n \x01(\t\x12\"\n\x1atask_space_indicator_label\x18\x0b \x01(\t\x12\x1f\n\x14in_task_space_weight\x18\x0c \x01(\x02:\x01\x31\x12 \n\x15out_task_space_weight\x18\r \x01(\x02:\x01\x31\x12!\n\x16pareto_min_loss_weight\x18\x0e \x01(\x02:\x01\x30\"\x9d\x04\n\x15InterventionTaskTower\x12\x12\n\ntower_name\x18\x01 \x02(\t\x12\x12\n\nlabel_name\x18\x02 \x01(\t\x12\x35\n\x07metrics\x18\x03 \x03(\x0b\x32$.tzrec_tpu_torch.protos.MetricConfig\x12@\n\rtrain_metrics\x18\x14 \x03(\x0b\x32).tzrec_tpu_torch.protos.TrainMetricConfig\x12\x32\n\x06losses\x18\x04 \x03(\x0b\x32\".tzrec_tpu_torch.protos.LossConfig\x12\x14\n\tnum_class\x18\x05 \x01(\r:\x01\x31\x12(\n\x03mlp\x18\x06 \x01(\x0b\x32\x1b.tzrec_tpu_torch.protos.MLP\x12\x11\n\x06weight\x18\x07 \x01(\x02:\x01\x31\x12 \n\x18intervention_tower_names\x18\x08 \x03(\t\x12\x14\n\x0clow_rank_dim\x18\t \x02(\r\x12\x1a\n\rdropout_ratio\x18\n \x01(\x02:\x03\x30.1\x12\"\n\x1atask_space_indicator_label\x18\x0b \x01(\t\x12\x1f\n\x14in_task_space_weight\x18\x0c \x01(\x02:\x01\x31\x12 \n\x15out_task_space_weight\x18\r \x01(\x02:\x01\x31\x12!\n\x16pareto_min_loss_weight\x18\x0e \x01(\x02:\x01\x30\"\xa8\x02\n\x13\x46usionSubTaskConfig\x12\x11\n\ttask_name\x18\x01 \x02(\t\x12\x12\n\nlabel_name\x18\x02 \x02(\t\x12\x14\n\x0ctask_bitmask\x18\x03 \x01(\x04\x12\x32\n\x06losses\x18\x04 \x03(\x0b\x32\".tzrec_tpu_torch.protos.LossConfig\x12\x14\n\tnum_class\x18\x05 \x01(\r:\x01\x31\x12\x35\n\x07metrics\x18\x06 \x03(\x0b\x32$.tzrec_tpu_torch.protos.MetricConfig\x12\x11\n\x06weight\x18\x07 \x01(\x02:\x01\x31\x12@\n\rtrain_metrics\x18\x14 \x03(\x0b\x32).tzrec_tpu_torch.protos.TrainMetricConfig\"}\n\x0e\x46usionMTLTower\x12(\n\x03mlp\x18\x01 \x01(\x0b\x32\x1b.tzrec_tpu_torch.protos.MLP\x12\x41\n\x0ctask_configs\x18\x02 \x03(\x0b\x32+.tzrec_tpu_torch.protos.FusionSubTaskConfig\"Y\n\x13MultiWindowDINTower\x12\x13\n\x0bwindows_len\x18\x01 \x03(\r\x12-\n\x08\x61ttn_mlp\x18\x02 \x02(\x0b\x32\x1b.tzrec_tpu_torch.protos.MLP\"Z\n\x08\x44\x41TTower\x12\r\n\x05input\x18\x01 \x02(\t\x12\x15\n\raugment_input\x18\x02 \x02(\t\x12(\n\x03mlp\x18\x03 \x02(\x0b\x32\x1b.tzrec_tpu_torch.protos.MLP\"\x8c\x03\n\rMINDUserTower\x12\r\n\x05input\x18\x01 \x02(\t\x12\x15\n\rhistory_input\x18\x02 \x02(\t\x12-\n\x08user_mlp\x18\x03 \x02(\x0b\x32\x1b.tzrec_tpu_torch.protos.MLP\x12\x31\n\x0chist_seq_mlp\x18\x04 \x01(\x0b\x32\x1b.tzrec_tpu_torch.protos.MLP\x12Y\n\x10user_seq_combine\x18\x05 \x01(\x0e\x32:.tzrec_tpu_torch.protos.MINDUserTower.UserSeqCombineMethod:\x03SUM\x12:\n\x0e\x63\x61psule_config\x18\x06 \x02(\x0b\x32\".tzrec_tpu_torch.protos.B2ICapsule\x12/\n\nconcat_mlp\x18\x07 \x02(\x0b\x32\x1b.tzrec_tpu_torch.protos.MLP\"+\n\x14UserSeqCombineMethod\x12\n\n\x06\x43ONCAT\x10\x00\x12\x07\n\x03SUM\x10\x01')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'torcheasyrec_tpu_torch.protos.tower_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _TOWER._serialized_start=199
  _TOWER._serialized_end=263
  _HSTUUSERTOWER._serialized_start=265
  _HSTUUSERTOWER._serialized_end=360
  _DINTOWER._serialized_start=362
  _DINTOWER._serialized_end=434
  _TASKTOWER._serialized_start=437
  _TASKTOWER._serialized_end=910
  _BAYESTASKTOWER._serialized_start=913
  _BAYESTASKTOWER._serialized_end=1472
  _INTERVENTIONTASKTOWER._serialized_start=1475
  _INTERVENTIONTASKTOWER._serialized_end=2016
  _FUSIONSUBTASKCONFIG._serialized_start=2019
  _FUSIONSUBTASKCONFIG._serialized_end=2315
  _FUSIONMTLTOWER._serialized_start=2317
  _FUSIONMTLTOWER._serialized_end=2442
  _MULTIWINDOWDINTOWER._serialized_start=2444
  _MULTIWINDOWDINTOWER._serialized_end=2533
  _DATTOWER._serialized_start=2535
  _DATTOWER._serialized_end=2625
  _MINDUSERTOWER._serialized_start=2628
  _MINDUSERTOWER._serialized_end=3024
  _MINDUSERTOWER_USERSEQCOMBINEMETHOD._serialized_start=2981
  _MINDUSERTOWER_USERSEQCOMBINEMETHOD._serialized_end=3024
# @@protoc_insertion_point(module_scope)
