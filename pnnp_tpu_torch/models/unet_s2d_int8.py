"""Opt-in W8A8 int8 serving path for the packed UNet forward (counterpart of
``pnnp_tpu/models/unet_s2d_int8.py``).

Scheme (standard W8A8), as the JAX module:
  * weights: per-output-channel symmetric int8 (scale = maxabs / 127);
  * activations: per-tensor static scales from a calibration pass
    (:func:`calibrate_act_scales`: the |x| percentile of every conv input
    over representative frames);
  * conv: exact ``int8 x int8 -> int32`` (:mod:`pnnp_tpu_torch.ops.int8conv`),
    dequantized by the per-channel multiplier ``m = s_act * s_w``.

Quantized by default (:data:`QUANT_LAYERS`): the interior 3x3 convs, conv1_2
to conv9_2, the decoder's split-add halves apart. In the serving dtype:
conv1_1 (it reads the raw 16-channel frame), the 2x2 transposed convs
(quantizable on request, :data:`OPTIONAL_QUANT`), the pools and the 1x1
head. Rounding is half-to-even and codes clip to +-127, in both packages;
the dequantized halves of a split-add conv are cast to the serving dtype
before they are combined, as JAX does. W8A8 is lossy: a checkpoint's PSNR
delta against the bf16 path is measured by
``pnnp_tpu_torch/tools/validate_int8.py``.

Layouts are :mod:`pnnp_tpu_torch.models.unet_s2d`'s (packed frames
``[N, 16, h, w]``, torch weight layouts).
"""

from __future__ import annotations

from typing import Iterable

import torch

from pnnp_tpu_torch.models.unet_s2d import (
    _conv_same,
    _group_max,
    _head,
    _lrelu,
    _pool,
    _upconv,
    _with_ones,
    transform_params_hybrid,
)
from pnnp_tpu_torch.ops.int8conv import conv3x3_int8, conv_transpose2x2_int8

# Conv inputs that get a static activation scale (in forward order).
QUANT_LAYERS = (
    "conv1_2",
    "conv2_1", "conv2_2", "conv3_1", "conv3_2", "conv4_1", "conv4_2",
    "conv5_1", "conv5_2",
    "conv6_1u", "conv6_1s", "conv6_2", "conv7_1u", "conv7_1s", "conv7_2",
    "conv8_1u", "conv8_1s", "conv8_2",
    "conv9_1u", "conv9_1s", "conv9_2",
)
# Quantizable on request, off in the default serving set: conv1_1 reads the
# raw packed frame; the 2x2 transposes are glue between quantized bands.
OPTIONAL_QUANT = ("conv1_1", "upv6", "upv7", "upv8")


def percentile(x: torch.Tensor, q: float) -> torch.Tensor:
    """``np.percentile(x, q)`` (linear interpolation) of all of ``x``, as a
    float32 0-dim tensor on its device. ``torch.quantile`` refuses more than
    2^24 elements (a full frame's level-1 activations hold 97M): this sorts
    and interpolates between the two order statistics itself, the position
    ``q/100 * (n-1)`` taken in float64 as numpy takes it."""
    v = x.reshape(-1).float()
    n = v.numel()
    if q >= 100.0:
        return v.max()
    pos = q / 100.0 * (n - 1)
    lo = int(pos)
    hi = min(lo + 1, n - 1)
    frac = pos - lo
    s = torch.sort(v).values
    a, b = s[lo], s[hi]
    return a + (b - a) * frac


def quantize(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """int8 codes of ``x`` at the per-tensor ``scale`` (a 0-dim tensor on
    ``x``'s device: a true division, as JAX's): round half-to-even, clip to
    +-127."""
    return torch.round(x.float() / scale).clamp_(-127, 127).to(torch.int8)


def _dequant(acc: torch.Tensor, layer: dict, bias: bool = True) -> torch.Tensor:
    """``acc * m (+ bias)`` in float32, per output channel."""
    y = acc.float().mul_(layer["m"][:, None, None])
    return y.add_(layer["bias"][:, None, None]) if bias else y


# The bands of the walk, in order (tools/profile_prefix_int8.py's prefixes):
# ``_walk(..., stop=i)`` returns the output of band i.
BANDS = ("head", "c2", "c3", "c4+c5", "c6+c7", "c8", "tail")


def _walk(tparams: dict, g1: torch.Tensor, dtype: torch.dtype, record=None,
          qparams=None, record_pct: float = 100.0, trace=None,
          stop=None) -> torch.Tensor:
    """The packed forward's skeleton (JAX's ``_walk``).

    ``record``: a dict to fill with each quantizable input's |x| statistic
    (the max, or the ``record_pct`` percentile; calibration). ``qparams``:
    quantized weights (int8 mode). With both None this is the bf16 hybrid
    forward. ``trace``: a list to append ``(name, codes)`` of every
    quantized input to (tests count flipped codes with it). ``stop``: the
    index in :data:`BANDS` of the last band to run; its output is returned
    (a prefix of the forward; None or 6 runs it all)."""
    k = lambda name: tparams[name]["kernel"]
    b = lambda name: tparams[name]["bias"]
    quantized = lambda name: qparams is not None and name in qparams["act_scale"]
    last = len(BANDS) - 1 if stop is None else stop

    def q(x, name):
        """Observe (calibration) or quantize (int8) a conv input."""
        if record is not None:
            ax = x.float().abs()
            v = ax.max() if record_pct >= 100.0 else percentile(ax, record_pct)
            record[name] = v if name not in record else torch.maximum(record[name], v)
        if quantized(name):
            codes = quantize(x, qparams["layers"][name]["s_act"])
            if trace is not None:
                trace.append((name, codes))
            return codes
        return x

    def conv_q(x, name):
        """3x3 SAME conv + bias + LeakyReLU, int8 when quantized."""
        xq = q(x, name)
        if quantized(name):
            layer = qparams["layers"][name]
            return _lrelu(_dequant(conv3x3_int8(xq, layer["kq"]), layer)).to(dtype)
        return _lrelu(_conv_same(x, k(name), b(name)))

    def split_add(xu, xs, name):
        """The two int8 halves of a split-add conv, each dequantized and
        cast to ``dtype`` before the combine (JAX's HBM-boundary choice)."""
        lu, ls = qparams["layers"][name + "u"], qparams["layers"][name + "s"]
        pu = _dequant(conv3x3_int8(q(xu, name + "u"), lu["kq"]), lu, bias=False).to(dtype)
        ps = _dequant(conv3x3_int8(q(xs, name + "s"), ls["kq"]), ls, bias=False).to(dtype)
        return _lrelu(pu.float() + ps.float() + lu["bias"][:, None, None]).to(dtype)

    def dec_conv_q(up_t, skip, name):
        if quantized(name + "u"):
            return split_add(up_t, skip, name)
        kk = k(name)
        cu = up_t.shape[1]
        q(up_t, name + "u")
        q(skip, name + "s")
        return _lrelu(_conv_same(up_t, kk[:, :cu], b(name)) + _conv_same(skip, kk[:, cu:]))

    def up(t, name):
        """2x2 stride-2 transpose, int8 on request (OPTIONAL_QUANT)."""
        tq = q(t, name)
        if quantized(name):
            layer = qparams["layers"][name]
            return _dequant(conv_transpose2x2_int8(tq, layer["kq"]), layer).to(dtype)
        return _upconv(t, k(name), b(name))

    g1 = g1.to(dtype)
    c1g = conv_q(conv_q(g1, "conv1_1"), "conv1_2")
    p1 = _group_max(c1g)
    if last == 0:
        return p1
    c2 = conv_q(conv_q(p1, "conv2_1"), "conv2_2")
    if last == 1:
        return c2
    c3 = conv_q(conv_q(_pool(c2), "conv3_1"), "conv3_2")
    if last == 2:
        return c3
    c4 = conv_q(conv_q(_pool(c3), "conv4_1"), "conv4_2")
    c5 = conv_q(conv_q(_pool(c4), "conv5_1"), "conv5_2")
    if last == 3:
        return c5
    c6 = conv_q(dec_conv_q(up(c5, "upv6"), c4, "conv6_1"), "conv6_2")
    c7 = conv_q(dec_conv_q(up(c6, "upv7"), c3, "conv7_1"), "conv7_2")
    if last == 4:
        return c7
    c8 = conv_q(dec_conv_q(up(c7, "upv8"), c2, "conv8_1"), "conv8_2")
    if last == 5:
        return c8

    up9_in = _with_ones(c8)
    if quantized("conv9_1u"):
        h9 = split_add(up9_in, c1g, "conv9_1")
    else:
        q(up9_in, "conv9_1u")
        q(c1g, "conv9_1s")
        h9 = _lrelu(_conv_same(up9_in, tparams["conv9_1"]["kernel_up"], b("conv9_1"))
                    + _conv_same(c1g, tparams["conv9_1"]["kernel_skip"]))
    c9g = conv_q(h9, "conv9_2")
    return _head(c9g, k("conv10_1"), b("conv10_1"))


def calibrate_act_scales(tparams: dict, frames: Iterable[torch.Tensor],
                         dtype: torch.dtype = torch.bfloat16, pct: float = 100.0,
                         combine: str = "max") -> dict:
    """Per-quant-input activation scales (python floats) over packed frames
    ``[n, 16, h, w]``: the |x| ``pct`` percentile mapped to 127 (100 =
    maxabs), per frame, combined over frames by ``max`` or ``mean``. Every
    observed input (QUANT_LAYERS and OPTIONAL_QUANT) gets a scale;
    :func:`quantize_params_int8`'s ``quant`` decides what quantizes."""
    record: dict = {}
    n = 0
    with torch.no_grad():
        for g1 in frames:
            rec: dict = {}
            _walk(tparams, g1, dtype, record=rec, record_pct=pct)
            n += 1
            for name, v in rec.items():
                v = float(v)
                if combine == "mean":
                    record[name] = record.get(name, 0.0) + v
                else:
                    record[name] = max(record.get(name, 0.0), v)
    if combine == "mean" and n:
        record = {name: v / n for name, v in record.items()}
    return {name: max(v, 1e-12) / 127.0 for name, v in record.items()}


def quantize_params_int8(tparams: dict, act_scales: dict,
                         quant: Iterable[str] = QUANT_LAYERS) -> dict:
    """Per-output-channel int8 weights and fused dequant multipliers:
    ``{"layers": {name: {"kq", "m", "bias", "s_act"}}, "act_scale": {name:
    float}}`` for :func:`unet_hybrid_forward_packed_int8`. ``kq`` keeps the
    torch layout of its kernel (OIHW; ``[I, O, 2, 2]`` for the transposed
    convs), ``m`` and ``bias`` are float32 ``[O]``, ``s_act`` the
    activation scale as a 0-dim float32 tensor on the kernel's device."""
    layers, scales = {}, {}

    def add(qname, kern, bias, out_dim=0):
        kern = kern.detach().float()
        red = tuple(d for d in range(kern.dim()) if d != out_dim)
        sw = kern.abs().amax(dim=red).clamp_min(1e-12) / 127.0
        shape = [1] * kern.dim()
        shape[out_dim] = -1
        sa = float(act_scales[qname])
        layers[qname] = {
            "kq": torch.round(kern / sw.reshape(shape)).clamp_(-127, 127).to(torch.int8),
            "m": (sw * torch.tensor(sa, dtype=torch.float32)).float(),
            "bias": bias.detach().float(),
            "s_act": torch.tensor(sa, dtype=torch.float32, device=kern.device),
        }
        scales[qname] = sa

    for name in set(quant):
        if name.startswith("conv9_1"):
            t = tparams["conv9_1"]
            if name == "conv9_1u":
                add(name, t["kernel_up"], t["bias"])
            else:
                add(name, t["kernel_skip"], torch.zeros_like(t["bias"]))
        elif name[-1] in ("u", "s") and name[:-1] in tparams:
            t = tparams[name[:-1]]
            cu = t["kernel"].shape[1] // 2  # split-add: up half = skip half
            if name.endswith("u"):
                add(name, t["kernel"][:, :cu], t["bias"])
            else:
                add(name, t["kernel"][:, cu:], torch.zeros_like(t["bias"]))
        else:
            t = tparams[name]
            add(name, t["kernel"], t["bias"], out_dim=1 if name.startswith("upv") else 0)
    return {"layers": layers, "act_scale": scales}


def unet_hybrid_forward_packed_int8(tparams: dict, qparams: dict, g1: torch.Tensor,
                                    dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """W8A8 packed serving forward; the I/O contract of the bf16 path."""
    return _walk(tparams, g1, dtype, qparams=qparams)


def unet_hybrid_forward_packed_ref(tparams: dict, g1: torch.Tensor,
                                   dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """The skeleton with no quantization: equals
    ``unet_s2d.unet_hybrid_forward_packed`` exactly."""
    return _walk(tparams, g1, dtype)


def build_int8_server(params, cal_frames: Iterable[torch.Tensor],
                      dtype: torch.dtype = torch.bfloat16, pct: float = 99.95):
    """Standard UNetSeeInDark weights (a module or its ``state_dict``) ->
    ``serve(g1) -> denoised`` in the packed layout, with the calibration
    (``pct``, max-combined) and the weight quantization done once here."""
    with torch.no_grad():
        tparams = transform_params_hybrid(params, dtype)
        qparams = quantize_params_int8(
            tparams, calibrate_act_scales(tparams, cal_frames, dtype, pct))

    @torch.no_grad()
    def serve(g1: torch.Tensor) -> torch.Tensor:
        return unet_hybrid_forward_packed_int8(tparams, qparams, g1, dtype)

    return serve
