"""Model registry: YAML ``arch.name`` -> ``nn.Module`` (counterpart of
``pnnp_tpu/models/registry.py``). Only ``UNetSeeInDark`` is ported; the
rest of the family waits for ROADMAP 1.13. :func:`build_proxy` builds the
noise proxy of a runfile's ``arch_proxy`` block."""

from __future__ import annotations

from typing import Any, Mapping, Optional

import torch

from pnnp_tpu_torch.models.proxy import PixelWiseISOProxy
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


def build_proxy(arch_proxy: Mapping[str, Any], wp: float = 16383.0, bl: float = 512.0,
                generator: Optional[torch.Generator] = None) -> PixelWiseISOProxy:
    """The ``pw_iso_2stage`` proxy of an ``arch_proxy`` block, with the keys
    and defaults the JAX Trainer reads (pnnp_tpu/trainer.py:275-285): ISO2K,
    nf, nb, d, mode, lookup, smooth_s0; ``wp``/``bl`` come from the ``dst``
    block. ``generator`` seeds flax's Dense init law. Built on the CPU."""
    name = str(arch_proxy.get("name", ""))
    if "NoiseFlow" in name or "noise_flow" in name:
        raise NotImplementedError(
            f"arch_proxy '{name}': NoiseFlow is not ported yet (ROADMAP 1.12)")
    if "pw_iso" not in name:
        raise KeyError(f"unknown arch_proxy '{name}'; known: pw_iso_2stage")
    return PixelWiseISOProxy(
        iso2k=tuple(arch_proxy.get("ISO2K", (0.0009546, -0.00193))),
        nf=int(arch_proxy.get("nf", 16)),
        nb=int(arch_proxy.get("nb", 2)),
        d=int(arch_proxy.get("d", 1024)),
        mode=arch_proxy.get("mode", "2stage+iso"),
        wp=float(wp), bl=float(bl),
        lookup=arch_proxy.get("lookup", "dot"),
        smooth_s0=float(arch_proxy.get("smooth_s0", 0.3)),
        generator=generator,
    )
