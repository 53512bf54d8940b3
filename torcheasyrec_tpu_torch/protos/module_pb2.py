# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: torcheasyrec_tpu_torch/protos/module.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n*torcheasyrec_tpu_torch/protos/module.proto\x12\x16tzrec_tpu_torch.protos\"\x91\x01\n\x03MLP\x12\x14\n\x0chidden_units\x18\x01 \x03(\r\x12\x15\n\rdropout_ratio\x18\x02 \x03(\x02\x12\x1b\n\nactivation\x18\x03 \x01(\t:\x07nn.ReLU\x12\x15\n\x06use_bn\x18\x04 \x01(\x08:\x05\x66\x61lse\x12\x12\n\x04\x62ias\x18\x05 \x01(\x08:\x04true\x12\x15\n\x06use_ln\x18\x06 \x01(\x08:\x05\x66\x61lse\"\xc6\x01\n\x11\x45xtractionNetwork\x12\x14\n\x0cnetwork_name\x18\x01 \x02(\t\x12\x1b\n\x13\x65xpert_num_per_task\x18\x02 \x02(\r\x12\x11\n\tshare_num\x18\x03 \x01(\r\x12\x34\n\x0ftask_expert_net\x18\x04 \x02(\x0b\x32\x1b.tzrec_tpu_torch.protos.MLP\x12\x35\n\x10share_expert_net\x18\x05 \x01(\x0b\x32\x1b.tzrec_tpu_torch.protos.MLP\"l\n\x12VariationalDropout\x12#\n\x15regularization_lambda\x18\x01 \x01(\x02:\x04\x30.01\x12\x31\n\"embedding_wise_variational_dropout\x18\x02 \x01(\x08:\x05\x66\x61lse\"\xfa\x01\n\nB2ICapsule\x12\x10\n\x05max_k\x18\x01 \x01(\r:\x01\x35\x12\x13\n\x0bmax_seq_len\x18\x02 \x02(\r\x12\x10\n\x08high_dim\x18\x03 \x02(\r\x12\x14\n\tnum_iters\x18\x04 \x01(\r:\x01\x33\x12 \n\x14routing_logits_scale\x18\x05 \x01(\x02:\x02\x32\x30\x12 \n\x15routing_logits_stddev\x18\x06 \x01(\x02:\x01\x31\x12\x15\n\nsquash_pow\x18\x07 \x01(\x02:\x01\x31\x12\x1d\n\x0e\x63onst_caps_num\x18\x08 \x01(\x08:\x05\x66\x61lse\x12#\n\x13routing_init_method\x18\t \x01(\t:\x06normal\"T\n\tMaskBlock\x12\x1a\n\x0freduction_ratio\x18\x01 \x01(\x02:\x01\x31\x12\x17\n\x0f\x61ggregation_dim\x18\x02 \x01(\r\x12\x12\n\nhidden_dim\x18\x03 \x02(\r\"\xa7\x01\n\rMaskNetModule\x12\x15\n\rn_mask_blocks\x18\x01 \x02(\r\x12\x35\n\nmask_block\x18\x02 \x02(\x0b\x32!.tzrec_tpu_torch.protos.MaskBlock\x12,\n\x07top_mlp\x18\x03 \x01(\x0b\x32\x1b.tzrec_tpu_torch.protos.MLP\x12\x1a\n\x0cuse_parallel\x18\x04 \x01(\x08:\x04true\"\x1d\n\x05\x43ross\x12\x14\n\tcross_num\x18\x01 \x01(\r:\x01\x33\"5\n\x07\x43rossV2\x12\x14\n\tcross_num\x18\x01 \x01(\r:\x01\x33\x12\x14\n\x08low_rank\x18\x02 \x01(\r:\x02\x33\x32\"\x1d\n\x03\x43IN\x12\x16\n\x0e\x63in_layer_size\x18\x01 \x03(\r\"\x99\x01\n\x0bWuKongLayer\x12\x17\n\x0flcb_feature_num\x18\x01 \x02(\r\x12\x17\n\x0f\x66mb_feature_num\x18\x02 \x02(\r\x12\"\n\x16\x63ompressed_feature_num\x18\x03 \x01(\r:\x02\x31\x36\x12\x34\n\x0f\x66\x65\x61ture_num_mlp\x18\x04 \x02(\x0b\x32\x1b.tzrec_tpu_torch.protos.MLP\"\xbb\x01\n\x15GRSimpleActionEncoder\x12\x1c\n\x14\x61\x63tion_embedding_dim\x18\x01 \x01(\r\x12\x16\n\x0e\x61\x63tion_weights\x18\x03 \x03(\r\x12&\n\x1ewatchtime_to_action_thresholds\x18\x04 \x03(\r\x12#\n\x1bwatchtime_to_action_weights\x18\x05 \x03(\r\x12\x1f\n\x12\x65mbedding_init_std\x18\x06 \x01(\x02:\x03\x30.1\"s\n\x0fGRActionEncoder\x12N\n\x15simple_action_encoder\x18\x01 \x01(\x0b\x32-.tzrec_tpu_torch.protos.GRSimpleActionEncoderH\x00\x42\x10\n\x0e\x61\x63tion_encoder\"\x17\n\x15GRSliceContentEncoder\"\x15\n\x13GRPadContentEncoder\"t\n\x13GRMLPContentEncoder\x12,\n\x07uih_mlp\x18\x01 \x02(\x0b\x32\x1b.tzrec_tpu_torch.protos.MLP\x12/\n\ntarget_mlp\x18\x02 \x02(\x0b\x32\x1b.tzrec_tpu_torch.protos.MLP\"\x8d\x02\n\x10GRContentEncoder\x12N\n\x15slice_content_encoder\x18\x01 \x01(\x0b\x32-.tzrec_tpu_torch.protos.GRSliceContentEncoderH\x00\x12J\n\x13pad_content_encoder\x18\x02 \x01(\x0b\x32+.tzrec_tpu_torch.protos.GRPadContentEncoderH\x00\x12J\n\x13mlp_content_encoder\x18\x03 \x01(\x0b\x32+.tzrec_tpu_torch.protos.GRMLPContentEncoderH\x00\x42\x11\n\x0f\x63ontent_encoder\"/\n\x19GRSimpleContextualizedMLP\x12\x12\n\nhidden_dim\x18\x01 \x02(\r\"]\n GRParameterizedContextualizedMLP\x12\x12\n\nhidden_dim\x18\x01 \x02(\r\x12%\n\x18\x63ontextual_dropout_ratio\x18\x02 \x01(\x02:\x03\x30.3\"\xcb\x01\n\x13GRContextualizedMLP\x12G\n\nsimple_mlp\x18\n \x01(\x0b\x32\x31.tzrec_tpu_torch.protos.GRSimpleContextualizedMLPH\x00\x12U\n\x11parameterized_mlp\x18\x0b \x01(\x0b\x32\x38.tzrec_tpu_torch.protos.GRParameterizedContextualizedMLPH\x00\x42\x14\n\x12\x63ontextualized_mlp\"\xa1\x02\n\x18GRContextualPreprocessor\x12?\n\x0e\x61\x63tion_encoder\x18\x03 \x01(\x0b\x32\'.tzrec_tpu_torch.protos.GRActionEncoder\x12?\n\naction_mlp\x18\x04 \x01(\x0b\x32+.tzrec_tpu_torch.protos.GRContextualizedMLP\x12\x41\n\x0f\x63ontent_encoder\x18\x05 \x02(\x0b\x32(.tzrec_tpu_torch.protos.GRContentEncoder\x12@\n\x0b\x63ontent_mlp\x18\x06 \x02(\x0b\x32+.tzrec_tpu_torch.protos.GRContextualizedMLP\"\xce\x02\n\"GRContextualInterleavePreprocessor\x12?\n\x0e\x61\x63tion_encoder\x18\x03 \x01(\x0b\x32\'.tzrec_tpu_torch.protos.GRActionEncoder\x12!\n\x13\x65nable_interleaving\x18\x04 \x01(\x08:\x04true\x12?\n\naction_mlp\x18\x05 \x01(\x0b\x32+.tzrec_tpu_torch.protos.GRContextualizedMLP\x12\x41\n\x0f\x63ontent_encoder\x18\x06 \x02(\x0b\x32(.tzrec_tpu_torch.protos.GRContentEncoder\x12@\n\x0b\x63ontent_mlp\x18\x07 \x02(\x0b\x32+.tzrec_tpu_torch.protos.GRContextualizedMLP\"\x95\x01\n\x11GRUIHPreprocessor\x12?\n\x0e\x61\x63tion_encoder\x18\x01 \x01(\x0b\x32\'.tzrec_tpu_torch.protos.GRActionEncoder\x12?\n\naction_mlp\x18\x02 \x01(\x0b\x32+.tzrec_tpu_torch.protos.GRContextualizedMLP\"\xb1\x02\n\x13GRInputPreprocessor\x12S\n\x17\x63ontextual_preprocessor\x18\x14 \x01(\x0b\x32\x30.tzrec_tpu_torch.protos.GRContextualPreprocessorH\x00\x12h\n\"contextual_interleave_preprocessor\x18\x15 \x01(\x0b\x32:.tzrec_tpu_torch.protos.GRContextualInterleavePreprocessorH\x00\x12\x45\n\x10uih_preprocessor\x18\x16 \x01(\x0b\x32).tzrec_tpu_torch.protos.GRUIHPreprocessorH\x00\x42\x14\n\x12input_preprocessor\"\x17\n\x15GRL2NormPostprocessor\"\x1a\n\x18GRLayerNormPostprocessor\"o\n!GRTimestampLayerNormPostprocessor\x12\"\n\x1atime_duration_period_units\x18\x01 \x03(\r\x12&\n\x1etime_duration_units_per_period\x18\x02 \x03(\r\"\xbb\x02\n\x15GROutputPostprocessor\x12M\n\x14l2norm_postprocessor\x18\x1f \x01(\x0b\x32-.tzrec_tpu_torch.protos.GRL2NormPostprocessorH\x00\x12S\n\x17layernorm_postprocessor\x18  \x01(\x0b\x32\x30.tzrec_tpu_torch.protos.GRLayerNormPostprocessorH\x00\x12\x66\n!timestamp_layernorm_postprocessor\x18! \x01(\x0b\x32\x39.tzrec_tpu_torch.protos.GRTimestampLayerNormPostprocessorH\x00\x42\x16\n\x14output_postprocessor\"\xb9\x03\n\x03STU\x12\x15\n\rembedding_dim\x18\x01 \x01(\r\x12\x14\n\tnum_heads\x18\x02 \x01(\r:\x01\x31\x12\x12\n\nhidden_dim\x18\x03 \x01(\r\x12\x15\n\rattention_dim\x18\x04 \x01(\r\x12\x1f\n\x14output_dropout_ratio\x18\x05 \x01(\x02:\x01\x30\x12\x17\n\x0cmax_attn_len\x18\x06 \x01(\r:\x01\x30\x12\x15\n\nattn_alpha\x18\x07 \x01(\x02:\x01\x30\x12\x1d\n\x0euse_group_norm\x18\x08 \x01(\x08:\x05\x66\x61lse\x12 \n\x12recompute_normed_x\x18\t \x01(\x08:\x04true\x12\x1c\n\x0erecompute_uvqk\x18\n \x01(\x08:\x04true\x12\x19\n\x0brecompute_y\x18\x0b \x01(\x08:\x04true\x12\x1c\n\x0esort_by_length\x18\x0c \x01(\x08:\x04true\x12\x1e\n\x12\x63ontextual_seq_len\x18\r \x01(\x05:\x02-1\x12\x0e\n\x06sla_k1\x18\x0e \x01(\r\x12\x0e\n\x06sla_k2\x18\x0f \x01(\r\x12\x1a\n\x0escaling_seqlen\x18\x10 \x01(\x05:\x02-1\x12\x15\n\nnum_layers\x18\x65 \x01(\r:\x01\x31\"\xb1\x01\n\x13GRPositionalEncoder\x12\x1c\n\x14num_position_buckets\x18\x01 \x02(\r\x12\x18\n\x10num_time_buckets\x18\x02 \x01(\r\x12 \n\x11use_time_encoding\x18\x03 \x01(\x08:\x05\x66\x61lse\x12\x1c\n\x0etime_bucket_fn\x18\x04 \x01(\t:\x04sqrt\x12\"\n\x16time_bucket_increments\x18\x05 \x01(\x02:\x02\x36\x30\"\xa2\x03\n\x04HSTU\x12(\n\x03stu\x18\x01 \x02(\x0b\x32\x1b.tzrec_tpu_torch.protos.STU\x12 \n\x13input_dropout_ratio\x18\x02 \x01(\x02:\x03\x30.2\x12\x1a\n\x0f\x61ttn_num_layers\x18\x03 \x01(\r:\x01\x33\x12G\n\x12positional_encoder\x18\x04 \x01(\x0b\x32+.tzrec_tpu_torch.protos.GRPositionalEncoder\x12G\n\x12input_preprocessor\x18\x05 \x01(\x0b\x32+.tzrec_tpu_torch.protos.GRInputPreprocessor\x12K\n\x14output_postprocessor\x18\x06 \x01(\x0b\x32-.tzrec_tpu_torch.protos.GROutputPostprocessor\x12#\n\x1b\x61ttn_truncation_split_layer\x18\x07 \x01(\r\x12 \n\x18\x61ttn_truncation_tail_len\x18\x08 \x01(\r\x12\x0c\n\x04name\x18\x65 \x01(\t')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'torcheasyrec_tpu_torch.protos.module_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _MLP._serialized_start=71
  _MLP._serialized_end=216
  _EXTRACTIONNETWORK._serialized_start=219
  _EXTRACTIONNETWORK._serialized_end=417
  _VARIATIONALDROPOUT._serialized_start=419
  _VARIATIONALDROPOUT._serialized_end=527
  _B2ICAPSULE._serialized_start=530
  _B2ICAPSULE._serialized_end=780
  _MASKBLOCK._serialized_start=782
  _MASKBLOCK._serialized_end=866
  _MASKNETMODULE._serialized_start=869
  _MASKNETMODULE._serialized_end=1036
  _CROSS._serialized_start=1038
  _CROSS._serialized_end=1067
  _CROSSV2._serialized_start=1069
  _CROSSV2._serialized_end=1122
  _CIN._serialized_start=1124
  _CIN._serialized_end=1153
  _WUKONGLAYER._serialized_start=1156
  _WUKONGLAYER._serialized_end=1309
  _GRSIMPLEACTIONENCODER._serialized_start=1312
  _GRSIMPLEACTIONENCODER._serialized_end=1499
  _GRACTIONENCODER._serialized_start=1501
  _GRACTIONENCODER._serialized_end=1616
  _GRSLICECONTENTENCODER._serialized_start=1618
  _GRSLICECONTENTENCODER._serialized_end=1641
  _GRPADCONTENTENCODER._serialized_start=1643
  _GRPADCONTENTENCODER._serialized_end=1664
  _GRMLPCONTENTENCODER._serialized_start=1666
  _GRMLPCONTENTENCODER._serialized_end=1782
  _GRCONTENTENCODER._serialized_start=1785
  _GRCONTENTENCODER._serialized_end=2054
  _GRSIMPLECONTEXTUALIZEDMLP._serialized_start=2056
  _GRSIMPLECONTEXTUALIZEDMLP._serialized_end=2103
  _GRPARAMETERIZEDCONTEXTUALIZEDMLP._serialized_start=2105
  _GRPARAMETERIZEDCONTEXTUALIZEDMLP._serialized_end=2198
  _GRCONTEXTUALIZEDMLP._serialized_start=2201
  _GRCONTEXTUALIZEDMLP._serialized_end=2404
  _GRCONTEXTUALPREPROCESSOR._serialized_start=2407
  _GRCONTEXTUALPREPROCESSOR._serialized_end=2696
  _GRCONTEXTUALINTERLEAVEPREPROCESSOR._serialized_start=2699
  _GRCONTEXTUALINTERLEAVEPREPROCESSOR._serialized_end=3033
  _GRUIHPREPROCESSOR._serialized_start=3036
  _GRUIHPREPROCESSOR._serialized_end=3185
  _GRINPUTPREPROCESSOR._serialized_start=3188
  _GRINPUTPREPROCESSOR._serialized_end=3493
  _GRL2NORMPOSTPROCESSOR._serialized_start=3495
  _GRL2NORMPOSTPROCESSOR._serialized_end=3518
  _GRLAYERNORMPOSTPROCESSOR._serialized_start=3520
  _GRLAYERNORMPOSTPROCESSOR._serialized_end=3546
  _GRTIMESTAMPLAYERNORMPOSTPROCESSOR._serialized_start=3548
  _GRTIMESTAMPLAYERNORMPOSTPROCESSOR._serialized_end=3659
  _GROUTPUTPOSTPROCESSOR._serialized_start=3662
  _GROUTPUTPOSTPROCESSOR._serialized_end=3977
  _STU._serialized_start=3980
  _STU._serialized_end=4421
  _GRPOSITIONALENCODER._serialized_start=4424
  _GRPOSITIONALENCODER._serialized_end=4601
  _HSTU._serialized_start=4604
  _HSTU._serialized_end=5022
# @@protoc_insertion_point(module_scope)
