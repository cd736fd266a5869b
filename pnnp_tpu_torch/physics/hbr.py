"""HighBitRecovery: remap quantized low-bit bias frames to continuous read
noise (counterpart of ``pnnp_tpu/physics/hbr.py``).

The reference builds a per-ISO CDF/PPF lookup table with scipy and loops over
every integer intensity on the CPU (reference: data_process/process.py:
675-751). Here the LUT is a pair of dense arrays built once on the host with
scipy, and :meth:`HighBitRecovery.map` is one gather plus an inverse-CDF
evaluation on the tensor's own device: the SonyA7S2 datasets call it on CPU
tensors in the loader (host code, as in JAX), the IMX686 synth on the card.

The LUT's noise parameters are one draw of
:func:`~pnnp_tpu_torch.physics.sampling.sample_params_max` from a
``torch.Generator`` seeded with ``seed + iso``: the same law as the JAX
package's draw from ``jax.random.key(seed + iso)``, other values, so the two
packages' LUTs agree only when ``param`` is passed in.
"""

from __future__ import annotations

import numpy as np
import torch
from scipy import stats

from pnnp_tpu_torch.ops.tukey import tukeylambda_ppf
from pnnp_tpu_torch.physics.sampling import sample_params_max


def _uniform(generator: torch.Generator, shape, device) -> torch.Tensor:
    """U[0, 1) of ``shape`` from ``generator``, on ``device``."""
    return torch.rand(shape, generator=generator, device=generator.device).to(device)


class HighBitRecovery:
    """LUT-based low-bit -> high-bit noise remapping.

    Parameters mirror the reference class: ``noise_code`` selects the read
    noise distribution ('g' -> Tukey-lambda, else Gaussian), ``factor`` is
    the +-N-sigma addressing range, ``use_float`` keeps sub-ADU deltas.
    """

    def __init__(self, camera_type="IMX686", noise_code="prq", perturb=True,
                 factor=6, use_float=True):
        self.camera_type = camera_type
        self.noise_code = noise_code
        self.perturb = perturb
        self.factor = factor
        self.use_float = use_float
        self.lut: dict = {}
        self._on_device: dict = {}

    def get_lut(self, iso_list, blc_mean=None, seed=0):
        # numpy, as in JAX: the bias perturbations are the same in both packages
        rng = np.random.default_rng(seed)
        for iso in iso_list:
            bias = 0.0 if blc_mean is None else float(np.mean(blc_mean[iso]))
            if self.perturb:
                bias += float(rng.standard_normal()) * 0.1
            self.lut[iso] = self._build(iso, bias, seed=seed)

    def _build(self, iso, bias=0.0, param=None, seed=0):
        if param is None:
            gen = torch.Generator().manual_seed(seed + int(iso))
            p = {k: float(v[0]) for k, v in
                 sample_params_max(gen, self.camera_type, n=1, iso=iso).items()
                 if v.dim() == 1}
        else:
            p = param
        use_tl = "g" in self.noise_code.lower()
        if use_tl:
            dist = stats.tukeylambda(float(p["lam"]), loc=bias, scale=float(p["sigTL"]))
            sigma = float(p["sigTL"])
        else:
            dist = stats.norm(loc=bias, scale=float(p["sigGs"]))
            sigma = float(p["sigGs"])

        low = max(int(-sigma * self.factor + bias), -int(p["bl"]) + 1)
        high = int(sigma * self.factor + bias)
        xs = np.arange(low, high)
        cdf_lo = dist.cdf(xs - 0.5)
        cdf_hi = dist.cdf(xs + 0.5)
        return dict(
            param=p,
            low=low,
            bias=np.float32(bias),
            use_tl=use_tl,
            lam=np.float32(p["lam"]),
            scale=np.float32(sigma),
            cdf=torch.as_tensor(cdf_lo, dtype=torch.float32),
            rng=torch.as_tensor(cdf_hi - cdf_lo, dtype=torch.float32),
        )

    def _tables(self, iso, device):
        """The ISO's (cdf, rng) arrays on ``device``, copied there once."""
        key = (iso, str(device))
        if key not in self._on_device:
            lut = self.lut[iso]
            self._on_device[key] = (lut["cdf"].to(device), lut["rng"].to(device))
        return self._on_device[key]

    def map(self, generator: torch.Generator, data: torch.Tensor, iso=6400,
            norm=True) -> torch.Tensor:
        """Remap quantized data (normalized [0, 1] or ADU) through the ISO's
        LUT, on ``data``'s device; values outside [low, high) pass through.
        Whether the data is normalized is the reference's test ``max(data)
        <= 1`` over the whole tensor, decided on the device (no host sync).
        """
        lut = self.lut[iso]
        p = lut["param"]
        cdf, rng = self._tables(iso, data.device)
        span = float(p["wp"]) - float(p["bl"])
        is_norm = data.max() <= 1.0
        data_adu = torch.where(is_norm, data * span, data)
        data_r = torch.round(data_adu)
        delta = data_adu - data_r

        idx = data_r.to(torch.int64) - lut["low"]
        nbin = cdf.shape[0]
        valid = (idx >= 0) & (idx < nbin)
        idx_c = idx.clamp(0, max(nbin - 1, 0))
        u = cdf[idx_c] + _uniform(generator, data.shape, data.device) * rng[idx_c]
        u = u.clamp(1e-7, 1.0 - 1e-7)
        if lut["use_tl"]:
            mapped = float(lut["bias"]) + float(lut["scale"]) * tukeylambda_ppf(
                u, float(lut["lam"]))
        else:
            mapped = float(lut["bias"]) + float(lut["scale"]) * torch.special.ndtri(u)
        out = torch.where(valid, mapped, data_r)
        if self.use_float:
            out = out + delta
        if norm:
            return out / span
        return out + float(p["bl"])
