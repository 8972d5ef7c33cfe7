"""PyTorch/CUDA port of ``ddp_tpu`` for NVIDIA Hopper (H100).

The module layout and class names mirror ``ddp_tpu`` so that each piece has
an obvious counterpart; the JAX package stays the reference. This package
imports torch, numpy and the standard library only — never jax, flax or
``ddp_tpu``. Importing it builds and loads nothing: the CUDA kernels are
compiled and loaded at first use (``ddp_tpu_torch/ops/_build.py``).

Ported so far: the segmentation serving path (``DDPSegmentor.sample`` of the
``ade20k_swin_t`` preset: Swin → FPN → MultiStageMerging, then the 3-step
DDIM rollout through the window-attention time-FiLM decoder, with the
argmax re-embedding on a hand-written CUDA kernel) and its training path
(``DDPSegmentor.forward``, ``train.step.make_train_step``, ``train.loop.train``:
the ground-truth corruption and its table gradient, and the fused ×4
upsample + cross-entropy forward and backward, on hand-written CUDA kernels),
with Swin or ConvNeXt backbones (the ADE20K and Cityscapes presets), the
window or msda decoder, mmseg checkpoint import, slide inference, the
ADE20K/Cityscapes datasets and the train/test entry points
(``python -m ddp_tpu_torch.tools.train`` / ``tools.test``); the NYUv2/KITTI
depthers; camera-only and camera + lidar BEV map segmentation (the lidar
branch's host C++ is built with g++ at first use, ``ddp_tpu_torch/native``);
mask-conditioned generation (``models/controlnet.py``: SD 1.5 with a
ControlNet, DDIM with classifier-free guidance, ``tools/control_demo.py``).
"""
