"""PyTorch/CUDA port of torcheasyrec_tpu (see README, "PyTorch/CUDA port")."""
