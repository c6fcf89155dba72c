"""PyTorch / CUDA port of unimp_tpu for NVIDIA Hopper GPUs.

Same subpackage layout and module names as ``unimp_tpu``; the attention
kernels are hand-written CUDA (``csrc/``) with plain PyTorch versions
beside them. Nothing here imports JAX.
"""
