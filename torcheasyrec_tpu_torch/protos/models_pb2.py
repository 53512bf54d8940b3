# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: torcheasyrec_tpu_torch/protos/models.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()


from torcheasyrec_tpu_torch.protos import module_pb2 as torcheasyrec__tpu__torch_dot_protos_dot_module__pb2
from torcheasyrec_tpu_torch.protos import tower_pb2 as torcheasyrec__tpu__torch_dot_protos_dot_tower__pb2
from torcheasyrec_tpu_torch.protos import simi_pb2 as torcheasyrec__tpu__torch_dot_protos_dot_simi__pb2


DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n*torcheasyrec_tpu_torch/protos/models.proto\x12\x16tzrec_tpu_torch.protos\x1a*torcheasyrec_tpu_torch/protos/module.proto\x1a)torcheasyrec_tpu_torch/protos/tower.proto\x1a(torcheasyrec_tpu_torch/protos/simi.proto\"\x99\x01\n\x0bWideAndDeep\x12)\n\x04\x64\x65\x65p\x18\x01 \x02(\x0b\x32\x1b.tzrec_tpu_torch.protos.MLP\x12*\n\x05\x66inal\x18\x02 \x01(\x0b\x32\x1b.tzrec_tpu_torch.protos.MLP\x12\x1d\n\x12wide_embedding_dim\x18\x03 \x01(\r:\x01\x34\x12\x14\n\x0cwide_init_fn\x18\x04 \x01(\t\"\x94\x01\n\x06\x44\x65\x65pFM\x12)\n\x04\x64\x65\x65p\x18\x01 \x02(\x0b\x32\x1b.tzrec_tpu_torch.protos.MLP\x12*\n\x05\x66inal\x18\x02 \x01(\x0b\x32\x1b.tzrec_tpu_torch.protos.MLP\x12\x1d\n\x12wide_embedding_dim\x18\x03 \x01(\r:\x01\x34\x12\x14\n\x0cwide_init_fn\x18\x04 \x01(\t\"g\n\nMultiTower\x12-\n\x06towers\x18\x01 \x03(\x0b\x32\x1d.tzrec_tpu_torch.protos.Tower\x12*\n\x05\x66inal\x18\x02 \x02(\x0b\x32\x1b.tzrec_tpu_torch.protos.MLP\"\xa0\x01\n\rMultiTowerDIN\x12-\n\x06towers\x18\x01 \x03(\x0b\x32\x1d.tzrec_tpu_torch.protos.Tower\x12\x34\n\ndin_towers\x18\x02 \x03(\x0b\x32 .tzrec_tpu_torch.protos.DINTower\x12*\n\x05\x66inal\x18\x03 \x02(\x0b\x32\x1b.tzrec_tpu_torch.protos.MLP\"\x82\x01\n\x04\x44LRM\x12.\n\tdense_mlp\x18\x01 \x01(\x0b\x32\x1b.tzrec_tpu_torch.protos.MLP\x12\x1e\n\x10\x61rch_with_sparse\x18\x02 \x01(\x08:\x04true\x12*\n\x05\x66inal\x18\x03 \x02(\x0b\x32\x1b.tzrec_tpu_torch.protos.MLP\"I\n\x07MaskNet\x12>\n\x0fmask_net_module\x18\x01 \x02(\x0b\x32%.tzrec_tpu_torch.protos.MaskNetModule\"\x8c\x01\n\x05\x44\x43NV1\x12,\n\x05\x63ross\x18\x01 \x02(\x0b\x32\x1d.tzrec_tpu_torch.protos.Cross\x12)\n\x04\x64\x65\x65p\x18\x02 \x02(\x0b\x32\x1b.tzrec_tpu_torch.protos.MLP\x12*\n\x05\x66inal\x18\x03 \x02(\x0b\x32\x1b.tzrec_tpu_torch.protos.MLP\"\xbd\x01\n\x05\x44\x43NV2\x12-\n\x08\x62\x61\x63kbone\x18\x01 \x01(\x0b\x32\x1b.tzrec_tpu_torch.protos.MLP\x12.\n\x05\x63ross\x18\x02 \x02(\x0b\x32\x1f.tzrec_tpu_torch.protos.CrossV2\x12)\n\x04\x64\x65\x65p\x18\x03 \x01(\x0b\x32\x1b.tzrec_tpu_torch.protos.MLP\x12*\n\x05\x66inal\x18\x04 \x02(\x0b\x32\x1b.tzrec_tpu_torch.protos.MLP\"\xc0\x01\n\x07xDeepFM\x12(\n\x03\x63in\x18\x01 \x02(\x0b\x32\x1b.tzrec_tpu_torch.protos.CIN\x12)\n\x04\x64\x65\x65p\x18\x02 \x02(\x0b\x32\x1b.tzrec_tpu_torch.protos.MLP\x12*\n\x05\x66inal\x18\x03 \x02(\x0b\x32\x1b.tzrec_tpu_torch.protos.MLP\x12\x1e\n\x12wide_embedding_dim\x18\x04 \x01(\r:\x02\x31\x36\x12\x14\n\x0cwide_init_fn\x18\x05 \x01(\t\"\xa0\x01\n\x06WuKong\x12.\n\tdense_mlp\x18\x01 \x01(\x0b\x32\x1b.tzrec_tpu_torch.protos.MLP\x12:\n\rwukong_layers\x18\x02 \x03(\x0b\x32#.tzrec_tpu_torch.protos.WuKongLayer\x12*\n\x05\x66inal\x18\x03 \x02(\x0b\x32\x1b.tzrec_tpu_torch.protos.MLP\"\xa1\x02\n\x0fRocketLaunching\x12.\n\tshare_mlp\x18\x01 \x01(\x0b\x32\x1b.tzrec_tpu_torch.protos.MLP\x12\x30\n\x0b\x62ooster_mlp\x18\x02 \x02(\x0b\x32\x1b.tzrec_tpu_torch.protos.MLP\x12.\n\tlight_mlp\x18\x03 \x02(\x0b\x32\x1b.tzrec_tpu_torch.protos.MLP\x12)\n\x1a\x66\x65\x61ture_based_distillation\x18\x05 \x01(\x08:\x05\x66\x61lse\x12Q\n\x1d\x66\x65\x61ture_distillation_function\x18\x06 \x01(\x0e\x32\".tzrec_tpu_torch.protos.Similarity:\x06\x43OSINE\"I\n\x0fSimpleMultiTask\x12\x36\n\x0btask_towers\x18\x01 \x03(\x0b\x32!.tzrec_tpu_torch.protos.TaskTower\"\xb5\x01\n\x04MMoE\x12/\n\nexpert_mlp\x18\x01 \x02(\x0b\x32\x1b.tzrec_tpu_torch.protos.MLP\x12-\n\x08gate_mlp\x18\x02 \x01(\x0b\x32\x1b.tzrec_tpu_torch.protos.MLP\x12\x15\n\nnum_expert\x18\x03 \x02(\r:\x01\x33\x12\x36\n\x0btask_towers\x18\x04 \x03(\x0b\x32!.tzrec_tpu_torch.protos.TaskTower\"\xa5\x02\n\x05\x44\x42MTL\x12\x37\n\x08mask_net\x18\x06 \x01(\x0b\x32%.tzrec_tpu_torch.protos.MaskNetModule\x12/\n\nbottom_mlp\x18\x01 \x01(\x0b\x32\x1b.tzrec_tpu_torch.protos.MLP\x12/\n\nexpert_mlp\x18\x02 \x01(\x0b\x32\x1b.tzrec_tpu_torch.protos.MLP\x12-\n\x08gate_mlp\x18\x03 \x01(\x0b\x32\x1b.tzrec_tpu_torch.protos.MLP\x12\x15\n\nnum_expert\x18\x04 \x01(\r:\x01\x33\x12;\n\x0btask_towers\x18\x05 \x03(\x0b\x32&.tzrec_tpu_torch.protos.BayesTaskTower\"\xf3\x01\n\x05\x44\x43\x32VR\x12/\n\nbottom_mlp\x18\x01 \x01(\x0b\x32\x1b.tzrec_tpu_torch.protos.MLP\x12/\n\nexpert_mlp\x18\x02 \x01(\x0b\x32\x1b.tzrec_tpu_torch.protos.MLP\x12-\n\x08gate_mlp\x18\x03 \x01(\x0b\x32\x1b.tzrec_tpu_torch.protos.MLP\x12\x15\n\nnum_expert\x18\x04 \x01(\r:\x01\x33\x12\x42\n\x0btask_towers\x18\x05 \x03(\x0b\x32-.tzrec_tpu_torch.protos.InterventionTaskTower\"\x85\x01\n\x03PLE\x12\x46\n\x13\x65xtraction_networks\x18\x01 \x03(\x0b\x32).tzrec_tpu_torch.protos.ExtractionNetwork\x12\x36\n\x0btask_towers\x18\x02 \x03(\x0b\x32!.tzrec_tpu_torch.protos.TaskTower\"\x9e\x02\n\x06PEPNet\x12\x19\n\x11\x65pnet_hidden_unit\x18\x01 \x01(\r\x12\x16\n\x0b\x65pnet_gamma\x18\x02 \x01(\x02:\x01\x32\x12\x1a\n\x12ppnet_hidden_units\x18\x03 \x03(\r\x12!\n\x10ppnet_activation\x18\x04 \x01(\t:\x07nn.ReLU\x12\x1b\n\x13ppnet_dropout_ratio\x18\x05 \x03(\x02\x12\x16\n\x0bppnet_gamma\x18\x06 \x01(\x02:\x01\x32\x12\x19\n\x11\x64omain_input_name\x18\x07 \x01(\t\x12\x1a\n\x0ftask_domain_num\x18\x08 \x01(\r:\x01\x31\x12\x36\n\x0btask_towers\x18\t \x03(\x0b\x32!.tzrec_tpu_torch.protos.TaskTower\"\xb9\x02\n\x08\x44lrmHSTU\x12*\n\x04hstu\x18\x01 \x02(\x0b\x32\x1c.tzrec_tpu_torch.protos.HSTU\x12@\n\x10\x66usion_mtl_tower\x18\x02 \x02(\x0b\x32&.tzrec_tpu_torch.protos.FusionMTLTower\x12\x13\n\x0bmax_seq_len\x18\x03 \x02(\r\x12&\n\x19item_embedding_hidden_dim\x18\x04 \x01(\r:\x03\x35\x31\x32\x12(\n\x1a\x65nable_global_average_loss\x18\x05 \x01(\x08:\x04true\x12-\n\x1fsequence_timestamp_is_ascending\x18\x06 \x01(\x08:\x04true\x12)\n\x1a\x63oncat_contextual_features\x18\x07 \x01(\x08:\x05\x66\x61lse\"\xba\x02\n\tUltraHSTU\x12*\n\x04hstu\x18\x01 \x03(\x0b\x32\x1c.tzrec_tpu_torch.protos.HSTU\x12@\n\x10\x66usion_mtl_tower\x18\x02 \x02(\x0b\x32&.tzrec_tpu_torch.protos.FusionMTLTower\x12\x13\n\x0bmax_seq_len\x18\x03 \x02(\r\x12&\n\x19item_embedding_hidden_dim\x18\x04 \x01(\r:\x03\x35\x31\x32\x12(\n\x1a\x65nable_global_average_loss\x18\x05 \x01(\x08:\x04true\x12-\n\x1fsequence_timestamp_is_ascending\x18\x06 \x01(\x08:\x04true\x12)\n\x1a\x63oncat_contextual_features\x18\x07 \x01(\x08:\x05\x66\x61lse\"\x81\x02\n\x04\x44SSM\x12\x31\n\nuser_tower\x18\x01 \x02(\x0b\x32\x1d.tzrec_tpu_torch.protos.Tower\x12\x31\n\nitem_tower\x18\x02 \x02(\x0b\x32\x1d.tzrec_tpu_torch.protos.Tower\x12\x12\n\noutput_dim\x18\x03 \x02(\x05\x12\x45\n\nsimilarity\x18\x04 \x01(\x0e\x32\".tzrec_tpu_torch.protos.Similarity:\rINNER_PRODUCT\x12\x16\n\x0btemperature\x18\x05 \x01(\x02:\x01\x31\x12 \n\x11in_batch_negative\x18\x06 \x01(\x08:\x05\x66\x61lse\"\x83\x02\n\x06\x44SSMV2\x12\x31\n\nuser_tower\x18\x01 \x02(\x0b\x32\x1d.tzrec_tpu_torch.protos.Tower\x12\x31\n\nitem_tower\x18\x02 \x02(\x0b\x32\x1d.tzrec_tpu_torch.protos.Tower\x12\x12\n\noutput_dim\x18\x03 \x02(\x05\x12\x45\n\nsimilarity\x18\x04 \x01(\x0e\x32\".tzrec_tpu_torch.protos.Similarity:\rINNER_PRODUCT\x12\x16\n\x0btemperature\x18\x05 \x01(\x02:\x01\x31\x12 \n\x11in_batch_negative\x18\x06 \x01(\x08:\x05\x66\x61lse\"\x91\x02\n\tHSTUMatch\x12\x39\n\nuser_tower\x18\x01 \x02(\x0b\x32%.tzrec_tpu_torch.protos.HSTUUserTower\x12\x31\n\nitem_tower\x18\x06 \x02(\x0b\x32\x1d.tzrec_tpu_torch.protos.Tower\x12\x15\n\noutput_dim\x18\x07 \x01(\x05:\x01\x30\x12\x45\n\nsimilarity\x18\x03 \x01(\x0e\x32\".tzrec_tpu_torch.protos.Similarity:\rINNER_PRODUCT\x12\x16\n\x0btemperature\x18\x04 \x01(\x02:\x01\x31\x12 \n\x11in_batch_negative\x18\x05 \x01(\x08:\x05\x66\x61lse\"\xbc\x02\n\x03\x44\x41T\x12\x34\n\nuser_tower\x18\x01 \x02(\x0b\x32 .tzrec_tpu_torch.protos.DATTower\x12\x34\n\nitem_tower\x18\x02 \x02(\x0b\x32 .tzrec_tpu_torch.protos.DATTower\x12\x12\n\noutput_dim\x18\x03 \x02(\x05\x12\x45\n\nsimilarity\x18\x04 \x01(\x0e\x32\".tzrec_tpu_torch.protos.Similarity:\rINNER_PRODUCT\x12\x16\n\x0btemperature\x18\x05 \x01(\x02:\x01\x31\x12 \n\x11in_batch_negative\x18\x06 \x01(\x08:\x05\x66\x61lse\x12\x19\n\x0c\x61mm_i_weight\x18\x07 \x02(\x02:\x03\x30.5\x12\x19\n\x0c\x61mm_u_weight\x18\x08 \x02(\x02:\x03\x30.5\"\x98\x02\n\x04MIND\x12\x39\n\nuser_tower\x18\x01 \x02(\x0b\x32%.tzrec_tpu_torch.protos.MINDUserTower\x12\x31\n\nitem_tower\x18\x02 \x02(\x0b\x32\x1d.tzrec_tpu_torch.protos.Tower\x12\x14\n\x08simi_pow\x18\x03 \x01(\x02:\x02\x31\x30\x12>\n\nsimilarity\x18\x04 \x01(\x0e\x32\".tzrec_tpu_torch.protos.Similarity:\x06\x43OSINE\x12 \n\x11in_batch_negative\x18\x05 \x01(\x08:\x05\x66\x61lse\x12\x16\n\x0btemperature\x18\x06 \x01(\x02:\x01\x31\x12\x12\n\noutput_dim\x18\x07 \x02(\x05\"w\n\x03TDM\x12\x44\n\x0fmultiwindow_din\x18\x01 \x02(\x0b\x32+.tzrec_tpu_torch.protos.MultiWindowDINTower\x12*\n\x05\x66inal\x18\x02 \x02(\x0b\x32\x1b.tzrec_tpu_torch.protos.MLP\"\xa5\x01\n\x11\x46\x61issKmeansConfig\x12\r\n\x05niter\x18\x01 \x01(\r\x12\r\n\x05nredo\x18\x02 \x01(\r\x12\x0c\n\x04seed\x18\x03 \x01(\r\x12\x1f\n\x17max_points_per_centroid\x18\x04 \x01(\r\x12\x1f\n\x17min_points_per_centroid\x18\x05 \x01(\r\x12\x11\n\tspherical\x18\x06 \x01(\x08\x12\x0f\n\x07verbose\x18\x07 \x01(\x08\"N\n\x0eSinkhornConfig\x12\x10\n\x05iters\x18\x01 \x01(\r:\x01\x35\x12\x13\n\x07\x65psilon\x18\x02 \x01(\x02:\x02\x31\x30\x12\x15\n\x07\x65nabled\x18\x03 \x01(\x08:\x04true\"P\n\x11\x43ontrastiveConfig\x12\x1a\n\x12pair_feature_group\x18\x01 \x02(\t\x12\x1f\n\x17pair_flag_feature_group\x18\x02 \x02(\t\"e\n\x18SidCandidateOutputConfig\x12\x16\n\x07\x65nabled\x18\x01 \x01(\x08:\x05\x66\x61lse\x12\x0f\n\x04topk\x18\x02 \x01(\r:\x01\x31\x12 \n\x08strategy\x18\x03 \x01(\t:\x0elast_layer_knn\"\xb8\x03\n\x08SidRqvae\x12\x15\n\tembed_dim\x18\x02 \x01(\r:\x02\x36\x34\x12\x13\n\x0bhidden_dims\x18\x03 \x03(\r\x12\x10\n\x08\x63odebook\x18\x05 \x03(\r\x12\x19\n\x0c\x66orward_mode\x18\x06 \x01(\t:\x03ste\x12\"\n\x13normalize_residuals\x18\x07 \x01(\x08:\x05\x66\x61lse\x12\x19\n\rdistance_type\x18\t \x01(\t:\x02l2\x12\x1d\n\x0erotation_trick\x18\x0c \x01(\x08:\x05\x66\x61lse\x12\x1a\n\x0bkmeans_init\x18\r \x01(\x08:\x05\x66\x61lse\x12?\n\x0fsinkhorn_config\x18\x0f \x01(\x0b\x32&.tzrec_tpu_torch.protos.SinkhornConfig\x12\x45\n\x12\x63ontrastive_config\x18\x10 \x01(\x0b\x32).tzrec_tpu_torch.protos.ContrastiveConfig\x12Q\n\x17\x63\x61ndidate_output_config\x18\x11 \x01(\x0b\x32\x30.tzrec_tpu_torch.protos.SidCandidateOutputConfig\"\xfc\x01\n\x0bSidRqkmeans\x12\x10\n\x08\x63odebook\x18\x03 \x03(\r\x12\"\n\x13normalize_residuals\x18\x04 \x01(\x08:\x05\x66\x61lse\x12\x46\n\x13\x66\x61iss_kmeans_kwargs\x18\x05 \x01(\x0b\x32).tzrec_tpu_torch.protos.FaissKmeansConfig\x12\x1c\n\x11train_sample_size\x18\x06 \x01(\r:\x01\x30\x12Q\n\x17\x63\x61ndidate_output_config\x18\x07 \x01(\x0b\x32\x30.tzrec_tpu_torch.protos.SidCandidateOutputConfig')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'torcheasyrec_tpu_torch.protos.models_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _WIDEANDDEEP._serialized_start=200
  _WIDEANDDEEP._serialized_end=353
  _DEEPFM._serialized_start=356
  _DEEPFM._serialized_end=504
  _MULTITOWER._serialized_start=506
  _MULTITOWER._serialized_end=609
  _MULTITOWERDIN._serialized_start=612
  _MULTITOWERDIN._serialized_end=772
  _DLRM._serialized_start=775
  _DLRM._serialized_end=905
  _MASKNET._serialized_start=907
  _MASKNET._serialized_end=980
  _DCNV1._serialized_start=983
  _DCNV1._serialized_end=1123
  _DCNV2._serialized_start=1126
  _DCNV2._serialized_end=1315
  _XDEEPFM._serialized_start=1318
  _XDEEPFM._serialized_end=1510
  _WUKONG._serialized_start=1513
  _WUKONG._serialized_end=1673
  _ROCKETLAUNCHING._serialized_start=1676
  _ROCKETLAUNCHING._serialized_end=1965
  _SIMPLEMULTITASK._serialized_start=1967
  _SIMPLEMULTITASK._serialized_end=2040
  _MMOE._serialized_start=2043
  _MMOE._serialized_end=2224
  _DBMTL._serialized_start=2227
  _DBMTL._serialized_end=2520
  _DC2VR._serialized_start=2523
  _DC2VR._serialized_end=2766
  _PLE._serialized_start=2769
  _PLE._serialized_end=2902
  _PEPNET._serialized_start=2905
  _PEPNET._serialized_end=3191
  _DLRMHSTU._serialized_start=3194
  _DLRMHSTU._serialized_end=3507
  _ULTRAHSTU._serialized_start=3510
  _ULTRAHSTU._serialized_end=3824
  _DSSM._serialized_start=3827
  _DSSM._serialized_end=4084
  _DSSMV2._serialized_start=4087
  _DSSMV2._serialized_end=4346
  _HSTUMATCH._serialized_start=4349
  _HSTUMATCH._serialized_end=4622
  _DAT._serialized_start=4625
  _DAT._serialized_end=4941
  _MIND._serialized_start=4944
  _MIND._serialized_end=5224
  _TDM._serialized_start=5226
  _TDM._serialized_end=5345
  _FAISSKMEANSCONFIG._serialized_start=5348
  _FAISSKMEANSCONFIG._serialized_end=5513
  _SINKHORNCONFIG._serialized_start=5515
  _SINKHORNCONFIG._serialized_end=5593
  _CONTRASTIVECONFIG._serialized_start=5595
  _CONTRASTIVECONFIG._serialized_end=5675
  _SIDCANDIDATEOUTPUTCONFIG._serialized_start=5677
  _SIDCANDIDATEOUTPUTCONFIG._serialized_end=5778
  _SIDRQVAE._serialized_start=5781
  _SIDRQVAE._serialized_end=6221
  _SIDRQKMEANS._serialized_start=6224
  _SIDRQKMEANS._serialized_end=6476
# @@protoc_insertion_point(module_scope)
