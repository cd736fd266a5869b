"""Model registry: YAML ``arch.name`` -> ``nn.Module`` (counterpart of
``pnnp_tpu/models/registry.py``): the UNet family under the reference's
names and the JAX package's. :func:`build_proxy` builds the
noise model of a runfile's ``arch_proxy`` block (the ``pw_iso_2stage`` proxy
or NoiseFlow); :func:`load_proxy_jax` and :func:`proxy_to_jax` move its
weights to and from the JAX checkpoint trees."""

from __future__ import annotations

from typing import Any, Mapping, Optional

import torch

from pnnp_tpu_torch.models.convert import (
    flow_params_from_jax,
    flow_params_to_jax,
    params_from_jax,
    params_to_jax,
)
from pnnp_tpu_torch.models.noise_flow import ARCH, NoiseFlow
from pnnp_tpu_torch.models.proxy import PixelWiseISOProxy
from pnnp_tpu_torch.models.unet import DeepResUNet, DeepUNet, ResUNet, UNetSeeInDark

_REGISTRY = {
    "UNetSeeInDark": UNetSeeInDark,
    "DeepUnet": DeepUNet,
    "DeepUNet": DeepUNet,
    "ResUnet": ResUNet,
    "ResUNet": ResUNet,
    "DeepResUnet": DeepResUNet,
    "DeepResUNet": DeepResUNet,
}

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
                generator: Optional[torch.Generator] = None):
    """The noise model of an ``arch_proxy`` block, built on the CPU.

    * ``NoiseFlow`` / ``noise_flow`` names: :class:`NoiseFlow` with the
      block's ``arch`` string and ``flow_permutation``.
    * ``pw_iso`` names: the ``pw_iso_2stage`` proxy with the keys and
      defaults the JAX Trainer reads (pnnp_tpu/trainer.py:275-285): ISO2K,
      nf, nb, d, mode, lookup, smooth_s0; ``wp``/``bl`` come from the
      ``dst`` block.

    ``generator`` seeds the init law (flax's, with other draws)."""
    name = str(arch_proxy.get("name", ""))
    if "NoiseFlow" in name or "noise_flow" in name:
        return NoiseFlow(arch=arch_proxy.get("arch", ARCH),
                         flow_permutation=int(arch_proxy.get("flow_permutation", 1)),
                         generator=generator)
    if "pw_iso" not in name:
        raise KeyError(f"unknown arch_proxy '{name}'; known: pw_iso_2stage, NoiseFlow")
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


def load_proxy_jax(proxy, params, batch_stats=None) -> None:
    """Load a JAX checkpoint's ``params`` (and NoiseFlow's ``batch_stats``)
    into ``proxy``, strictly, in place."""
    state = (flow_params_from_jax(params, batch_stats) if isinstance(proxy, NoiseFlow)
             else params_from_jax(params))
    proxy.load_state_dict(state, strict=True)


def proxy_to_jax(proxy):
    """``proxy``'s weights as the JAX checkpoint trees (params, batch_stats);
    the proxy has no ``batch_stats``: ``{}``."""
    if isinstance(proxy, NoiseFlow):
        return flow_params_to_jax(proxy.state_dict())
    return params_to_jax(proxy.state_dict()), {}
