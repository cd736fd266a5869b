"""Model registry: YAML ``arch.name`` -> ``nn.Module`` (counterpart of
``pnnp_tpu/models/registry.py``). Only ``UNetSeeInDark`` is ported; the
rest of the family waits for ROADMAP 1.13."""

from __future__ import annotations

from typing import Any, Mapping, Optional

import torch

from pnnp_tpu_torch.models.unet import UNetSeeInDark

_REGISTRY = {"UNetSeeInDark": UNetSeeInDark}
_NOT_PORTED = ("DeepUnet", "DeepUNet", "ResUnet", "ResUNet", "DeepResUnet",
               "DeepResUNet")

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "bf16": torch.bfloat16}


def build_model(arch: Mapping[str, Any], dtype: Optional[torch.dtype] = None,
                generator: Optional[torch.Generator] = None):
    """Instantiate a denoiser from a runfile ``arch`` block.

    Recognized keys: name, in_nc, out_nc, nf, res, nframes, dtype.
    ``nframes`` multiplies the input channel count (reference: Unet.py:16).
    ``dtype`` overrides the block's ``dtype`` key; ``generator`` seeds the
    N(0, 0.02) init. The module is built on the CPU: move it with ``.to``.
    """
    name = arch["name"]
    if name in _NOT_PORTED:
        raise KeyError(f"arch '{name}' is not ported yet (ROADMAP 1.13)")
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch '{name}'; known: {sorted(_REGISTRY)}")
    if dtype is None:
        dtype_name = str(arch.get("dtype", "float32"))
        if dtype_name not in _DTYPES:
            raise KeyError(
                f"unknown dtype '{dtype_name}'; known: {sorted(_DTYPES)}")
        dtype = _DTYPES[dtype_name]
    return _REGISTRY[name](
        in_nc=int(arch.get("in_nc", 4)) * int(arch.get("nframes", 1)),
        out_nc=int(arch.get("out_nc", 4)),
        nf=int(arch.get("nf", 32)),
        res=bool(arch.get("res", False)),
        dtype=dtype,
        generator=generator,
    )
