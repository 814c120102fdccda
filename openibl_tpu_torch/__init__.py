"""openibl_tpu_torch — the PyTorch/CUDA port of openibl_tpu.

The serving path of the JAX package (VGG16 + NetVLAD + PCA descriptors,
exact top-k retrieval, the warm-model ``RetrievalService``) rewritten on
PyTorch, with the fused NetVLAD head as a hand-written CUDA kernel for
Hopper (``ops/netvlad_kernel.py``, ``csrc/netvlad.cu``). Module names follow
the JAX package so each counterpart is easy to find; public functions keep
its layouts (images (N, H, W, 3), feature maps (N, H, W, C), K-major VLAD
flatten). This package never imports jax.
"""

__version__ = "0.1.0"
