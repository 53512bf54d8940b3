# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: torcheasyrec_tpu_torch/protos/train.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()


from torcheasyrec_tpu_torch.protos import optimizer_pb2 as torcheasyrec__tpu__torch_dot_protos_dot_optimizer__pb2
from torcheasyrec_tpu_torch.protos import feature_pb2 as torcheasyrec__tpu__torch_dot_protos_dot_feature__pb2


DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n)torcheasyrec_tpu_torch/protos/train.proto\x12\x16tzrec_tpu_torch.protos\x1a-torcheasyrec_tpu_torch/protos/optimizer.proto\x1a+torcheasyrec_tpu_torch/protos/feature.proto\"}\n\nGradScaler\x12\x19\n\ninit_scale\x18\x01 \x01(\x02:\x05\x36\x35\x35\x33\x36\x12\x18\n\rgrowth_factor\x18\x02 \x01(\x02:\x01\x32\x12\x1b\n\x0e\x62\x61\x63koff_factor\x18\x03 \x01(\x02:\x03\x30.5\x12\x1d\n\x0fgrowth_interval\x18\x04 \x01(\r:\x04\x32\x30\x30\x30\"\x82\x01\n\x0cGradClipping\x12\x1b\n\rclipping_type\x18\x01 \x01(\t:\x04none\x12\x17\n\x0cmax_gradient\x18\x02 \x01(\x02:\x01\x31\x12\x14\n\tnorm_type\x18\x03 \x01(\x02:\x01\x32\x12&\n\x17\x65nable_global_grad_clip\x18\x04 \x01(\x08:\x05\x66\x61lse\"w\n\x18\x44\x65ltaEmbeddingDumpConfig\x12!\n\x13\x64ump_interval_steps\x18\x01 \x01(\r:\x04\x31\x30\x30\x30\x12\x12\n\noutput_dir\x18\x02 \x01(\t\x12$\n\x0b\x66ile_prefix\x18\x03 \x01(\t:\x0f\x64\x65lta_embedding\"\xcb\x08\n\x0bTrainConfig\x12\x41\n\x10sparse_optimizer\x18\x01 \x02(\x0b\x32\'.tzrec_tpu_torch.protos.SparseOptimizer\x12?\n\x0f\x64\x65nse_optimizer\x18\x02 \x02(\x0b\x32&.tzrec_tpu_torch.protos.DenseOptimizer\x12\x11\n\tnum_steps\x18\x03 \x01(\r\x12\x12\n\nnum_epochs\x18\x04 \x01(\r\x12$\n\x16save_checkpoints_steps\x18\x05 \x01(\r:\x04\x31\x30\x30\x30\x12\x1c\n\x14\x66ine_tune_checkpoint\x18\x06 \x01(\t\x12 \n\x18\x66ine_tune_ckpt_param_map\x18\x07 \x01(\t\x12!\n\x14log_step_count_steps\x18\x08 \x01(\r:\x03\x31\x30\x30\x12\x1b\n\x0cis_profiling\x18\t \x01(\x08:\x05\x66\x61lse\x12\x1d\n\x0fuse_tensorboard\x18\n \x01(\x08:\x04true\x12\x1f\n\x17save_checkpoints_epochs\x18\x0b \x01(\r\x12\x1d\n\x15tensorboard_summaries\x18\x0c \x03(\t\x12\x1e\n\x10\x63udnn_allow_tf32\x18\r \x01(\x08:\x04true\x12%\n\x16\x63uda_matmul_allow_tf32\x18\x0e \x01(\x08:\x05\x66\x61lse\x12R\n\x1cglobal_embedding_constraints\x18\x0f \x01(\x0b\x32,.tzrec_tpu_torch.protos.ParameterConstraints\x12\x17\n\x0fmixed_precision\x18\x10 \x01(\t\x12\x37\n\x0bgrad_scaler\x18\x11 \x01(\x0b\x32\".tzrec_tpu_torch.protos.GradScaler\x12#\n\x1bgradient_accumulation_steps\x18\x12 \x01(\r\x12;\n\rgrad_clipping\x18\x13 \x01(\x0b\x32$.tzrec_tpu_torch.protos.GradClipping\x12\x1e\n\x13keep_checkpoint_max\x18\x14 \x01(\r:\x01\x30\x12.\n#save_checkpoints_timestamp_interval\x18\x15 \x01(\r:\x01\x30\x12#\n\x1bsave_checkpoints_timestamps\x18\x16 \x03(\x04\x12.\n!save_checkpoints_timestamp_quorum\x18\x17 \x01(\x02:\x03\x30.5\x12U\n\x1b\x64\x65lta_embedding_dump_config\x18\x18 \x01(\x0b\x32\x30.tzrec_tpu_torch.protos.DeltaEmbeddingDumpConfig\x12\x1d\n\x12steps_per_dispatch\x18\x19 \x01(\r:\x01\x31\x12\"\n\x13sparse_dist_overlap\x18\x1a \x01(\x08:\x05\x66\x61lse')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'torcheasyrec_tpu_torch.protos.train_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _GRADSCALER._serialized_start=161
  _GRADSCALER._serialized_end=286
  _GRADCLIPPING._serialized_start=289
  _GRADCLIPPING._serialized_end=419
  _DELTAEMBEDDINGDUMPCONFIG._serialized_start=421
  _DELTAEMBEDDINGDUMPCONFIG._serialized_end=540
  _TRAINCONFIG._serialized_start=543
  _TRAINCONFIG._serialized_end=1642
# @@protoc_insertion_point(module_scope)
