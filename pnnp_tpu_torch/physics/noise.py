"""The physics noise synthesis, batched, on the device (counterpart of
``pnnp_tpu/physics/noise.py:37-148``).

Implements the reference's ``noise_code`` char DSL (reference:
data_process/process.py:591-673):

    p = Poisson shot noise        g = Tukey-lambda read (else Gaussian sigGs)
    r = per-(channel,row) noise   q = uniform quantization noise
    d = per-channel dark bias     b = black-frame mode (no read/row/q/d)

Composition (ADU domain): ``z = (shot + read + row + quant + bias) / (wp-bl)``,
clipped to ``[-bl/wp, 1]`` (sensor floor) or ``[0, 1]``, then scaled by the
exposure ratio unless ``ori``.

Also the PMN-style augmentations of real pairs (``:150-325`` there):
shot-noise augmentation :func:`sna`, :func:`raw_wb_aug`, :func:`random_gains`
and the WB-gain sampler :func:`get_aug_param`.

Layout is NCHW, the port's: images ``[n, 4, h, w]`` RGBG, params ``[n]`` per
example (from :mod:`pnnp_tpu_torch.physics.sampling`). Every draw comes from
the generator passed in, on its device, and nothing syncs with the host. The
stages are plain torch ops: the JAX package leaves this synthesis to XLA (no
Pallas kernel).
"""

from __future__ import annotations

import torch

from pnnp_tpu_torch.config import NoiseCode
from pnnp_tpu_torch.ops.poisson import poisson_sample
from pnnp_tpu_torch.ops.tukey import tukeylambda_sample
from pnnp_tpu_torch.physics import calibration as calib
from pnnp_tpu_torch.physics.sampling import _uniform, params_at_iso_regression


def _b(x: torch.Tensor) -> torch.Tensor:
    """Broadcast a [n] param vector against [n, c, h, w] images."""
    return x.reshape(-1, 1, 1, 1)


def generate_noisy(
    generator: torch.Generator,
    y: torch.Tensor,
    params: dict,
    noise_code: str = "p",
    ori: bool = False,
    clip: bool = False,
) -> torch.Tensor:
    """Synthesize a noisy observation from clean RGBG ``y`` [n, 4, h, w] in
    [0, 1].

    Port of ``generate_noisy_torch`` (reference: process.py:634-673) with the
    numpy path's black-frame semantics (row/quant/bias suppressed under 'b',
    reference: process.py:609-622). The JAX function's MultiFrameMean
    factor ``mfm`` is left out: no recipe sets it (it is 1 everywhere).
    """
    nc = NoiseCode(noise_code)
    g = generator
    n, c, h, _ = y.shape

    scale = params["wp"] - params["bl"]  # [n]
    y_adu = y * _b(scale / params["ratio"])
    K = _b(params["K"])

    if nc.shot_poisson:
        z = poisson_sample(g, (y_adu / K).clamp_min_(0.0))
        z *= K
    else:
        # Gaussian stand-in for shot noise: variance y*K, the Poisson
        # branch's (see the JAX module).
        std = (y_adu / K).clamp_min_(1e-10).sqrt_()
        z = torch.randn(y.shape, generator=g, device=g.device).mul_(std * K)
        z += y_adu

    if not nc.black_mode:
        if nc.read_tukey:
            z += tukeylambda_sample(g, _b(params["lam"]), _b(params["sigTL"]), y.shape)
        else:
            z += torch.randn(y.shape, generator=g, device=g.device) * _b(params["sigGs"])
        if nc.row:
            # one draw per (example, channel, row), broadcast over w
            z += torch.randn((n, c, h, 1), generator=g, device=g.device) * _b(params["sigR"])
        if nc.quant:
            z += (torch.rand(y.shape, generator=g, device=g.device) - 0.5) * _b(
                params["q"] * scale)
        if nc.dark_bias:
            z += params["bias"][:, :, None, None]

    z /= _b(scale)
    if clip:
        z.clamp_(0.0, 1.0)
    else:
        z = torch.maximum(z, _b(-params["bl"] / params["wp"])).clamp_max_(1.0)
    if not ori:
        z *= _b(params["ratio"])
    return z


def _k_and_wp_for(generator: torch.Generator, camera_type: str, iso, n: int = 1):
    """Per-example (K, wp, bl) [n] at float ISOs ``iso`` [n]: the SonyA7S2
    regression, else the nearest table ISO's K with a +-1% jitter;
    ``iso=None`` -> the table's top-ISO K with the jitter (reference:
    process.py:517-518)."""
    g, dev = generator, generator.device
    table = calib.ISO_TABLES.get(camera_type)
    if iso is None:
        K = float(table["Kmax"][-1]) * (1.0 + _uniform(g, n, -0.01, 0.01))
    elif camera_type == "SonyA7S2":
        p = params_at_iso_regression(g, camera_type, iso)
        return p["K"], p["wp"], p["bl"]
    else:
        iso = torch.as_tensor(iso, dtype=torch.float32, device=dev).reshape(-1)
        iso_arr = torch.as_tensor(table["iso"], device=dev)
        idx = torch.argmin((iso[:, None] - iso_arr[None, :]).abs(), dim=1)
        n = iso.shape[0]
        K = torch.as_tensor(table["Kmax"], device=dev)[idx] * (1.0 + _uniform(g, n, -0.01, 0.01))
    full = lambda v: torch.full((n,), float(v), device=dev)
    return K, full(table["wp"]), full(table["bl"])


def _per_example(x, n: int, device) -> torch.Tensor:
    """A scalar, a python bool or an [n] array as a float32 [n] tensor."""
    return torch.as_tensor(x, dtype=torch.float32, device=device).reshape(-1).expand(n)


def sna(generator: torch.Generator, gt: torch.Tensor, aug_wb: torch.Tensor,
        camera_type: str = "IMX686", ratio=1.0, iso=None, black_lr=False,
        ori: bool = True):
    """Shot-Noise-Augmentation: brightness/WB delta plus matched Poisson noise.

    Port of ``SNA_torch`` (reference: process.py:562-588), batched over
    ``gt [n, 4, h, w]`` with per-example ``aug_wb [n, 4]`` (RGBG channel
    gains), ``ratio [n]`` and ``iso [n]``. ``black_lr`` is a python bool or a
    per-example [n] 0/1 array (a batch may mix pasted bias frames with paired
    data). Returns ``(dn, dy)``: the noise delta for the LR image and the
    signal delta for the GT.
    """
    n, dev = gt.shape[0], gt.device
    ratio = _per_example(ratio, n, dev)
    K, wp, bl = _k_and_wp_for(generator, camera_type, iso, n)
    scale = wp - bl
    gt_adu = gt * _b(scale) / _b(ratio)
    dy = gt_adu * aug_wb[:, :, None, None]
    Kb = _b(K)
    dn = poisson_sample(generator, (dy / Kb).clamp_min(0.0)) * Kb
    # a pasted black frame as LR: remove the extra Poisson component the GT
    # already carries (reference: process.py:581)
    dy = dy - gt_adu * _b(_per_example(black_lr, n, dev))
    dy = dy * _b(ratio) / _b(scale)
    dn = dn / _b(scale)
    if not ori:
        dn = dn * _b(ratio)
    return dn, dy


def raw_wb_aug(generator: torch.Generator, noisy: torch.Tensor, gt: torch.Tensor,
               aug_wb, camera_type: str = "IMX686", ratio=1.0, iso=None,
               ori: bool = True):
    """Gain-only white-balance augmentation of a *real* noisy/clean pair.

    Port of ``raw_wb_aug_torch`` (reference: process.py:504-560), gain-only
    branch (the reference raises NotImplementedError for reductions).
    Batched like :func:`sna`.
    """
    n, dev = gt.shape[0], gt.device
    ratio = _per_example(ratio, n, dev)
    if aug_wb is None:
        if not ori:
            noisy = noisy * _b(ratio)
        return noisy, gt
    K, wp, bl = _k_and_wp_for(generator, camera_type, iso, n)
    scale = wp - bl
    gt_adu = gt * _b(scale) / _b(ratio)
    noisy_adu = noisy * _b(scale)
    dy = gt_adu * aug_wb[:, :, None, None]
    Kb = _b(K)
    dn = poisson_sample(generator, (dy / Kb).clamp_min(0.0)) * Kb
    gt_out = torch.minimum(((gt_adu + dy) * _b(ratio)).clamp_min(0.0), _b(scale)) / _b(scale)
    noisy_out = torch.minimum(torch.maximum(noisy_adu + dn, _b(-bl)), _b(scale)) / _b(scale)
    if not ori:
        noisy_out = noisy_out * _b(ratio)
    return noisy_out, gt_out


# blue gain as a polynomial of the red gain, per camera (reference:
# data_process/unprocess.py:60-77)
_GAIN_LAWS = {
    "SonyA7S2": ((1.75, 2.65), (14.65, -9.63942308, 1.80288462)),
    "IMX686": ((1.4, 2.3), (6.14381188, -3.65620261, 0.70205967)),
}


def random_gains(generator: torch.Generator, camera_type: str = "SonyA7S2", n: int = 1):
    """Random brightening + WB gains with the camera-fit blue polynomial.

    Port of ``random_gains`` (reference: data_process/unprocess.py:60-77).
    Returns ``(rgb_gain, red_gain, blue_gain)`` each ``[n]``.
    """
    if camera_type not in _GAIN_LAWS:
        raise NotImplementedError(camera_type)
    (lo, hi), poly = _GAIN_LAWS[camera_type]
    g = generator
    rgb_gain = 1.0 / (0.8 + 0.1 * torch.randn(n, generator=g, device=g.device))
    red_gain = _uniform(g, n, lo, hi)
    blue_gain = poly[0] + poly[1] * red_gain + poly[2] * red_gain ** 2
    return rgb_gain, red_gain, blue_gain


def aug_param_draws(generator: torch.Generator, n: int, command: str = "augv5",
                    camera_type: str = "SonyA7S2") -> dict:
    """The random draws of :func:`get_aug_param`, on the generator's device:
    ``r_bit`` (0/1) and ``aug_bit`` (0..3) [1] integers, per batch; with
    ``augv5`` the batch's ``gains`` (:func:`random_gains`, n=1) and three
    uniforms [n]; with ``augv2`` three normals [n]."""
    g, dev = generator, generator.device
    d = {"r_bit": torch.randint(2, (1,), generator=g, device=dev),
         "aug_bit": torch.randint(4, (1,), generator=g, device=dev)}
    if "augv5" in command:
        d["gains"] = random_gains(g, camera_type, 1)
        d["u"] = [torch.rand(n, generator=g, device=dev) for _ in range(3)]
    elif "augv2" in command:
        d["z"] = [torch.randn(n, generator=g, device=dev) for _ in range(3)]
    return d


def aug_params_from_draws(draws: dict, wb: torch.Tensor, n: int, command: str = "augv5"):
    """:func:`get_aug_param`'s deltas from its draws (see
    :func:`aug_param_draws`): ``(aug_r, aug_g, aug_b)`` [n]."""
    r = draws["r_bit"].float() * 0.25 + 0.25
    zero = torch.zeros(n, device=r.device)
    if "augv5" in command:
        rgb_gain, red_gain, blue_gain = draws["gains"]
        rgb_gain = 1.0 / rgb_gain
        rg = wb[:, 0] / red_gain[0]
        bg = wb[:, 2] / blue_gain[0]
        u3, u4, u5 = draws["u"]
        aug_g = u3 * r + rgb_gain[0] - 0.9
        aug_r = u4 * r + rg * (1 + aug_g) - 1.1
        aug_b = u5 * r + bg * (1 + aug_g) - 1.1
    elif "augv2" in command:
        top = 4 * r
        z3, z4, z5 = draws["z"]
        aug_g = torch.minimum((z3 * r).clamp_min(0.0), top)
        aug_r = torch.minimum(((1 + z4 * r) * (1 + aug_g) - 1).clamp_min(0.0), top)
        aug_b = torch.minimum(((1 + z5 * r) * (1 + aug_g) - 1).clamp_min(0.0), top)
    else:
        aug_r = aug_g = aug_b = zero
    do_aug = draws["aug_bit"] > 0
    aug_r, aug_g, aug_b = (torch.where(do_aug, a, zero) for a in (aug_r, aug_g, aug_b))
    # joint shift so that the smallest channel delta is >= 0 (reference:
    # process.py:435-440)
    daug = torch.minimum(torch.minimum(aug_r, aug_g), aug_b).clamp_max(0.0)
    return tuple((1 + a) / (1 + daug) - 1 for a in (aug_r, aug_g, aug_b))


def get_aug_param(generator: torch.Generator, wb: torch.Tensor, n: int = 8,
                  command: str = "augv5", camera_type: str = "SonyA7S2"):
    """WB-augmentation gain sampler (reference: process.py:415-445).

    ``wb`` is the batch's camera white balance ``[n, 4]`` (RGBG). The spread
    ``r`` and whether to augment at all are drawn once per call (per batch),
    the deltas per example. Returns per-example ``(aug_r, aug_g, aug_b)``
    [n], jointly shifted so that all are >= 0 after the renormalization.
    """
    draws = aug_param_draws(generator, n, command, camera_type)
    return aug_params_from_draws(draws, wb, n, command)
