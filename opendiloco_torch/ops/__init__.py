"""Attention and serving kernels: plain PyTorch versions beside the
hand-written CUDA kernels (``csrc/``) and their build."""
