"""PyTorch/CUDA port of ``pnnp_tpu`` for NVIDIA Hopper (H100).

The layout mirrors ``pnnp_tpu/`` module for module. The package imports
``torch`` and ``numpy`` only, never JAX or the JAX package: entry points run
on ``cuda`` unless the caller passes ``device="cpu"``. The SSIM metric runs
through a hand-written CUDA kernel (``csrc/ssim.cu``) on the card and through
its plain-torch version on the CPU.
"""
