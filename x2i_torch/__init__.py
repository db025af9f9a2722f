"""x2i in PyTorch and CUDA for NVIDIA Hopper: the port of x2i_tpu (see
README.md, "PyTorch/CUDA port")."""
