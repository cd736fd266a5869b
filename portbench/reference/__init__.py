"""The benchmark's plain reference: straightforward PyTorch and NumPy that
decide whether what the port's timed path produced is correct.

Nothing here imports ``jax``, ``pnnp_tpu`` or ``pnnp_tpu_torch``, and
nothing takes weights, scales or tables that the port derived: the harness
hands both sides the same seeded weights and raw files, and the reference
works out everything else again. Float32 computations run with TF32 off.
"""

import torch


def exact_f32() -> None:
    """Float32 matmuls and convolutions in full float32 (no TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
