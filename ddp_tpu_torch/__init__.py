"""PyTorch/CUDA port of ``ddp_tpu`` for NVIDIA Hopper (H100).

The module layout and class names mirror ``ddp_tpu`` so that each piece has
an obvious counterpart; the JAX package stays the reference. This package
imports torch, numpy and the standard library only — never jax, flax or
``ddp_tpu``. Importing it builds and loads nothing: the CUDA kernels are
compiled and loaded at first use (``ddp_tpu_torch/ops/_build.py``).

Ported so far: the segmentation serving path (``DDPSegmentor.sample`` of the
``ade20k_swin_t`` preset: Swin → FPN → MultiStageMerging, then the 3-step
DDIM rollout through the window-attention time-FiLM decoder, with the
argmax re-embedding on a hand-written CUDA kernel).
"""
