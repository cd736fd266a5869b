"""Space-to-depth (s2d) forms of UNetSeeInDark: exact, packed layout
(counterpart of ``pnnp_tpu/models/unet_s2d.py``).

The same network function evaluated in a space-to-depth representation: a
feature map ``[N, C, H, W]`` is stored as ``[N, 4C, H/2, W/2]``, its channel
groups the four 2x2 sub-positions in JAX's group-major order
``(2*aH + aW)*C + c``. Then

  * a 3x3 SAME conv on ``[C, H, W]`` is a 3x3 SAME conv on the s2d tensor
    with a block-structured kernel ``[4D, 4C, 3, 3]`` (:func:`transform_conv3_dense`,
    the production form; :func:`_transform_conv3_kernel` and
    :func:`_s2d_conv_pre` are the 2x2 reference construction);
  * 2x2 max-pool is the elementwise max over the 4 groups;
  * the 2x2 stride-2 transposed conv is a 1x1 conv producing all 4 groups;
  * the 1x1 head is block-diagonal over the groups.

Layouts are the port's: NCHW-logical tensors, a packed frame ``[N, 16, h, w]``
in ``channels_last`` memory. Weights stay in torch's layouts (``nn.Conv2d``
OIHW, ``nn.ConvTranspose2d`` ``[I, O, kh, kw]``); every transform here is an
index gather or an einsum of them, so it is differentiable.

The convolutions stay on cuDNN, as the JAX package leaves them to XLA: no
hand kernel is owed here (the JAX module has no Pallas kernel).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

_CL = torch.channels_last


# ---------------------------------------------------------------------------
# Layout and packing
# ---------------------------------------------------------------------------


def s2d(x: torch.Tensor) -> torch.Tensor:
    """``[N, C, H, W]`` -> ``[N, 4C, H/2, W/2]``, group-major channels
    (g = 2*aH + aW), in ``channels_last`` memory."""
    n, c, H, W = x.shape
    t = x.permute(0, 2, 3, 1).reshape(n, H // 2, 2, W // 2, 2, c)
    t = t.permute(0, 1, 3, 2, 4, 5).reshape(n, H // 2, W // 2, 4 * c)
    return t.permute(0, 3, 1, 2)


def d2s(g: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`s2d`: ``[N, 4C, h, w]`` -> ``[N, C, 2h, 2w]``
    (``channels_last`` memory)."""
    n, c4, h, w = g.shape
    c = c4 // 4
    t = g.permute(0, 2, 3, 1).reshape(n, h, w, 2, 2, c)
    t = t.permute(0, 1, 3, 2, 4, 5).reshape(n, 2 * h, 2 * w, c)
    return t.permute(0, 3, 1, 2)


def s2d_np(x):
    """Host (numpy) s2d over NHWC: ``[N, H, W, C]`` -> ``[N, H/2, W/2, 4C]``
    (the JAX module's ``s2d_np``, bit-identical)."""
    n, H, W, c = x.shape
    x = x.reshape(n, H // 2, 2, W // 2, 2, c)
    x = np.ascontiguousarray(x.transpose(0, 1, 3, 2, 4, 5))
    return x.reshape(n, H // 2, W // 2, 4 * c)


def d2s_np(g):
    """Host (numpy) mirror of :func:`s2d_np`'s inverse."""
    n, h, w, c4 = g.shape
    c = c4 // 4
    x = g.reshape(n, h, w, 2, 2, c)
    x = np.ascontiguousarray(x.transpose(0, 1, 3, 2, 4, 5))
    return x.reshape(n, 2 * h, 2 * w, c)


# ---------------------------------------------------------------------------
# Weights
# ---------------------------------------------------------------------------


def _layers(params) -> dict:
    """``{name: (weight, bias)}`` of a UNetSeeInDark module or of its
    ``state_dict``-style mapping (``"conv1_1.weight"`` ...)."""
    if isinstance(params, nn.Module):
        return {name: (m.weight, m.bias) for name, m in params.named_children()
                if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d))}
    out = {}
    for key in params:
        name, leaf = key.rsplit(".", 1)
        if leaf == "weight":
            out[name] = (params[key], params[name + ".bias"])
    return out


def _dense_index() -> np.ndarray:
    """Gather map of :func:`transform_conv3_dense`: ``[go, gi, p, q]`` ->
    the original tap ``3*(dy+1) + (dx+1)``, or 9 (a structural zero)."""
    idx = np.full((4, 4, 3, 3), 9, np.int64)
    for p in (-1, 0, 1):
        for q in (-1, 0, 1):
            for a_i in (0, 1):
                for a_w in (0, 1):
                    for o_i in (0, 1):
                        for o_w in (0, 1):
                            dy = 2 * p + a_i - o_i
                            dx = 2 * q + a_w - o_w
                            if abs(dy) <= 1 and abs(dx) <= 1:
                                idx[2 * o_i + o_w, 2 * a_i + a_w, p + 1, q + 1] = (
                                    3 * (dy + 1) + dx + 1)
    return idx


def _block_index() -> np.ndarray:
    """Gather map of :func:`_transform_conv3_kernel` (2x2 taps): tap t and
    input group a feed output group a' with the original tap
    ``2*(a' + t - 1) + a - a'`` when that is within [-1, 1]."""
    idx = np.full((4, 4, 2, 2), 9, np.int64)
    for a_h in (0, 1):
        for a_w in (0, 1):
            for t_h in (0, 1):
                for t_w in (0, 1):
                    for ap_h in (0, 1):
                        for ap_w in (0, 1):
                            dy = 2 * (ap_h + t_h - 1) + a_h - ap_h
                            dx = 2 * (ap_w + t_w - 1) + a_w - ap_w
                            if abs(dy) <= 1 and abs(dx) <= 1:
                                idx[2 * ap_h + ap_w, 2 * a_h + a_w, t_h, t_w] = (
                                    3 * (dy + 1) + dx + 1)
    return idx


_DENSE_IDX = _dense_index()
_BLOCK_IDX = _block_index()


def _gather_taps(k3: torch.Tensor, idx: np.ndarray) -> torch.Tensor:
    """OIHW 3x3 kernel ``[D, C, 3, 3]`` -> ``[4D, 4C, kh, kw]`` by the gather
    map ``idx [go, gi, kh, kw]`` (9 = zero): exact copies, differentiable."""
    D, C = k3.shape[:2]
    flat = torch.cat([k3.reshape(D, C, 9), k3.new_zeros(D, C, 1)], dim=2)
    g = flat[:, :, torch.from_numpy(idx).to(k3.device)]  # [D, C, go, gi, kh, kw]
    kh, kw = idx.shape[2:]
    return g.permute(2, 0, 3, 1, 4, 5).reshape(4 * D, 4 * C, kh, kw)


def transform_conv3_dense(k3: torch.Tensor) -> torch.Tensor:
    """OIHW ``[D, C, 3, 3]`` -> dense s2d form ``[4D, 4C, 3, 3]`` (structural
    zeros). Per spatial dim: tap p and groups (a_in, a_out) carry the
    original tap ``dy = 2p + a_in - a_out`` when |dy| <= 1."""
    return _gather_taps(k3, _DENSE_IDX)


def _transform_conv3_kernel(k3: torch.Tensor) -> torch.Tensor:
    """OIHW ``[D, C, 3, 3]`` -> the 2x2 s2d block kernel ``[4D, 4C, 2, 2]``
    of the reference construction (:func:`_s2d_conv_pre`)."""
    return _gather_taps(k3, _BLOCK_IDX)


def _up_weight_1x1(kt: torch.Tensor) -> torch.Tensor:
    """``nn.ConvTranspose2d`` weight ``[Cin, Cout, 2, 2]`` -> the 1x1 conv
    ``[4*Cout, Cin, 1, 1]`` producing the s2d form of its output. torch's
    stride-2 transposed conv writes tap (a, b) to output sub-position
    (a, b), so output group ``2*a_h + a_w`` takes tap ``(a_h, a_w)``
    (flax applies its kernel flipped, hence the JAX module's
    ``(1-a_h, 1-a_w)``; ``models/convert.py`` flips between the two)."""
    cin, cout = kt.shape[:2]
    return kt.permute(2, 3, 1, 0).reshape(4 * cout, cin, 1, 1)


def transform_params(params, dtype: torch.dtype = torch.bfloat16) -> dict:
    """Pre-transform the standard UNetSeeInDark weights for the reference
    s2d forward (:func:`unet_s2d_forward_pre`): the 3x3 kernels to their 2x2
    block forms, the transposed convs to their 1x1 forms; conv5_* and the
    head unchanged. ``{name: {"kernel", "bias"}}`` in ``dtype``."""
    out = {}
    for name, (w, b) in _layers(params).items():
        w, b = w.to(dtype), b.to(dtype)
        if name.startswith("upv"):
            out[name] = {"kernel": _up_weight_1x1(w), "bias": b.repeat(4)}
        elif name.startswith("conv5_") or name == "conv10_1":
            out[name] = {"kernel": w, "bias": b}
        else:
            out[name] = {"kernel": _transform_conv3_kernel(w), "bias": b.repeat(4)}
    return out


def _lrelu(x):
    return F.leaky_relu(x, 0.2)


def _s2d_conv_pre(g: torch.Tensor, kp: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """2x2 s2d-form conv with a pre-transformed kernel (and tiled bias): pad
    1, VALID conv, then each output group's shifted slice."""
    D = kp.shape[0] // 4
    h, w = g.shape[-2:]
    o = F.conv2d(F.pad(g, (1, 1, 1, 1)), kp)
    groups = [o[:, go * D:(go + 1) * D, ap_h:ap_h + h, ap_w:ap_w + w]
              for go, (ap_h, ap_w) in enumerate(((0, 0), (0, 1), (1, 0), (1, 1)))]
    return torch.cat(groups, dim=1) + bias[:, None, None]


def _group_max(g: torch.Tensor) -> torch.Tensor:
    """2x2 max-pool (full-resolution semantics): the max over the 4
    sub-position groups."""
    cg = g.shape[1] // 4
    return torch.maximum(torch.maximum(g[:, :cg], g[:, cg:2 * cg]),
                         torch.maximum(g[:, 2 * cg:3 * cg], g[:, 3 * cg:]))


def _up_as_1x1(f: torch.Tensor, kt: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """2x2 stride-2 transposed conv (``nn.ConvTranspose2d`` weight ``kt``
    ``[Cin, Cout, 2, 2]``) -> the s2d form of the upsampled tensor."""
    return F.conv2d(f, _up_weight_1x1(kt), bias.repeat(4))


def _group_concat(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Channel concat in full-resolution semantics: concat within each group."""
    n, ca, h, w = a.shape
    cb = b.shape[1]
    return torch.cat([a.reshape(n, 4, ca // 4, h, w), b.reshape(n, 4, cb // 4, h, w)],
                     dim=2).reshape(n, ca + cb, h, w)


def _head(c9g: torch.Tensor, kh: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """The 1x1 head, block-diagonal over the 4 groups: a grouped 1x1 conv."""
    return F.conv2d(c9g, kh.repeat(4, 1, 1, 1), bias.repeat(4), groups=4)


def unet_s2d_forward_pre(tparams: dict, x: torch.Tensor, res: bool = False,
                         dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """The reference s2d forward from :func:`transform_params` weights:
    ``x`` ``[N, 4, H, W]`` (H, W divisible by 32) -> float32 ``[N, 4, H, W]``."""
    k = lambda name: tparams[name]["kernel"]
    b = lambda name: tparams[name]["bias"]
    xl = x.to(dtype)
    conv = lambda g, name: _lrelu(_s2d_conv_pre(g, k(name), b(name)))

    g1 = s2d(xl)
    c1 = conv(conv(g1, "conv1_1"), "conv1_2")
    g2 = s2d(_group_max(c1))
    c2 = conv(conv(g2, "conv2_1"), "conv2_2")
    g3 = s2d(_group_max(c2))
    c3 = conv(conv(g3, "conv3_1"), "conv3_2")
    g4 = s2d(_group_max(c3))
    c4 = conv(conv(g4, "conv4_1"), "conv4_2")
    f5 = _group_max(c4)

    std_conv = lambda t, name: _lrelu(F.conv2d(t, k(name), b(name), padding=1))
    c5 = std_conv(std_conv(f5, "conv5_1"), "conv5_2")

    up = lambda f, name: F.conv2d(f, k(name), b(name))
    u6 = _group_concat(up(c5, "upv6"), c4)
    c6 = conv(conv(u6, "conv6_1"), "conv6_2")
    u7 = _group_concat(up(d2s(c6), "upv7"), c3)
    c7 = conv(conv(u7, "conv7_1"), "conv7_2")
    u8 = _group_concat(up(d2s(c7), "upv8"), c2)
    c8 = conv(conv(u8, "conv8_1"), "conv8_2")
    u9 = _group_concat(up(d2s(c8), "upv9"), c1)
    c9 = conv(conv(u9, "conv9_1"), "conv9_2")

    out = d2s(_head(c9, k("conv10_1"), b("conv10_1")))
    if res:
        out = out + xl
    return out.float()


def unet_s2d_forward(params, x: torch.Tensor, res: bool = False,
                     dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """UNetSeeInDark (standard weights) through the reference s2d forward:
    transforms inline, then :func:`unet_s2d_forward_pre`."""
    return unet_s2d_forward_pre(transform_params(params, dtype), x, res=res, dtype=dtype)


# ---------------------------------------------------------------------------
# The hybrid packed forward: dense-s2d 3x3 at level 1 only (the production
# form): levels 2-8 run in the true layout.
# ---------------------------------------------------------------------------


def _fold_conv91(params):
    """f32 dense-s2d fold of upv9 into conv9_1. Returns (kf ``[4nf, 2nf, 3,
    3]`` up-path over c8, k_sk ``[4nf, 4nf, 3, 3]`` skip path, kb_row
    ``[4nf, 3, 3]`` the ones-channel kernel carrying upv9's bias with exact
    SAME borders, the tiled conv9_1 bias ``[4nf]``)."""
    layers = _layers(params)
    k91, b91 = (t.float() for t in layers["conv9_1"])  # [nf, 2nf, 3, 3]
    kt, bup = (t.float() for t in layers["upv9"])      # [2nf, nf, 2, 2]
    nf = k91.shape[0]
    k91d = transform_conv3_dense(k91)                  # [4nf, 8nf, 3, 3]
    rows = np.arange(8 * nf).reshape(4, 2 * nf)
    up_rows = torch.from_numpy(rows[:, :nf].reshape(-1)).to(k91.device)
    sk_rows = torch.from_numpy(rows[:, nf:].reshape(-1)).to(k91.device)
    k_up = k91d[:, up_rows]                            # [4nf(e), 4nf(d), 3, 3]
    k_sk = k91d[:, sk_rows]
    w1 = _up_weight_1x1(kt)[:, :, 0, 0]                # [4nf(d), 2nf(c)]
    kf = torch.einsum("edpq,dc->ecpq", k_up, w1)       # [4nf, 2nf, 3, 3]
    kb_row = torch.einsum("edpq,d->epq", k_up, bup.repeat(4))
    return kf, k_sk, kb_row, b91.repeat(4)


def _cl(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous(memory_format=_CL) if t.dim() == 4 else t


def transform_params_hybrid(params, dtype: torch.dtype = torch.bfloat16) -> dict:
    """The weights of :func:`unet_hybrid_forward_packed` from the standard
    ones (a UNetSeeInDark module or its ``state_dict``): conv1_1, conv1_2
    and conv9_2 in dense-s2d form, upv9 folded into conv9_1 (its s2d form
    is a per-pixel 1x1, which commutes with the conv that follows: conv9_1
    becomes one conv over ``[c8 | ones]``, the ones channel carrying upv9's
    bias under SAME zero padding, plus the skip conv), the rest unchanged.
    Folds run in f32 and cast to ``dtype`` once; kernels in
    ``channels_last`` memory. Differentiable."""
    out = {}
    for name, (w, b) in _layers(params).items():
        if name in ("conv1_1", "conv1_2", "conv9_2"):
            out[name] = {"kernel": _cl(transform_conv3_dense(w.float()).to(dtype)),
                         "bias": b.float().repeat(4).to(dtype)}
        elif name in ("conv9_1", "upv9"):
            continue  # folded jointly below
        else:
            out[name] = {"kernel": _cl(w.to(dtype)), "bias": b.to(dtype)}
    kf, k_sk, kb_row, b91 = _fold_conv91(params)
    out["conv9_1"] = {
        "kernel_up": _cl(torch.cat([kf, kb_row[:, None]], dim=1).to(dtype)),  # [4nf, 2nf+1, 3, 3]
        "kernel_skip": _cl(k_sk.to(dtype)),
        "bias": b91.to(dtype),
    }
    return out


def _conv_same(t, kk, bias=None):
    return F.conv2d(t, kk, bias, padding=kk.shape[-1] // 2)


def _pool(t):
    return F.max_pool2d(t, 2)


def _upconv(t, kk, bias):
    return F.conv_transpose2d(t, kk, bias, stride=2)


def _dec_conv(tparams: dict, up_t: torch.Tensor, skip: torch.Tensor, name: str) -> torch.Tensor:
    """A decoder level's first conv, split-add: the upsampled and the skip
    halves convolved apart, so the channel concat is never formed."""
    kk, cu = tparams[name]["kernel"], up_t.shape[1]
    return _lrelu(_conv_same(up_t, kk[:, :cu], tparams[name]["bias"])
                  + _conv_same(skip, kk[:, cu:]))


def _mid_levels(tparams: dict, p1: torch.Tensor) -> torch.Tensor:
    """Levels 2-8 of the packed forward (true-layout convs): p1 -> c8."""
    k = lambda name: tparams[name]["kernel"]
    b = lambda name: tparams[name]["bias"]
    conv = lambda t, name: _lrelu(_conv_same(t, k(name), b(name)))
    up = lambda t, name: _upconv(t, k(name), b(name))
    dec_conv = lambda up_t, skip, name: _dec_conv(tparams, up_t, skip, name)

    c2 = conv(conv(p1, "conv2_1"), "conv2_2")
    c3 = conv(conv(_pool(c2), "conv3_1"), "conv3_2")
    c4 = conv(conv(_pool(c3), "conv4_1"), "conv4_2")
    c5 = conv(conv(_pool(c4), "conv5_1"), "conv5_2")
    c6 = conv(dec_conv(up(c5, "upv6"), c4, "conv6_1"), "conv6_2")
    c7 = conv(dec_conv(up(c6, "upv7"), c3, "conv7_1"), "conv7_2")
    return conv(dec_conv(up(c7, "upv8"), c2, "conv8_1"), "conv8_2")


def _with_ones(c8: torch.Tensor) -> torch.Tensor:
    """``[c8 | ones]``: the ones channel carries the folded upv9 bias."""
    ones = c8.new_ones((c8.shape[0], 1) + tuple(c8.shape[2:]))
    return torch.cat([c8, ones], dim=1)


def _conv9_1(tparams: dict, c8: torch.Tensor, c1g: torch.Tensor) -> torch.Tensor:
    """conv9_1 with upv9 folded in: one conv over ``[c8 | ones]`` plus the
    skip conv of ``c1g``."""
    t9 = tparams["conv9_1"]
    return _lrelu(_conv_same(_with_ones(c8), t9["kernel_up"], t9["bias"])
                  + _conv_same(c1g, t9["kernel_skip"]))


def _tail(tparams: dict, c8: torch.Tensor, c1g: torch.Tensor) -> torch.Tensor:
    """Level 9 and the head: :func:`_conv9_1`, conv9_2, the group-diagonal
    1x1 head."""
    b = lambda name: tparams[name]["bias"]
    c9g = _lrelu(_conv_same(_conv9_1(tparams, c8, c1g), tparams["conv9_2"]["kernel"],
                            b("conv9_2")))
    return _head(c9g, tparams["conv10_1"]["kernel"], b("conv10_1"))


def unet_hybrid_forward_packed(tparams: dict, g1: torch.Tensor,
                               res_x: Optional[torch.Tensor] = None,
                               dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """The hybrid forward over a packed frame: ``g1`` ``[N, 16, h, w]``
    (= :func:`s2d` of the ``[N, 4, H, W]`` RGBG frame, H and W divisible by
    32) -> the denoised frame in the same packed layout, in ``dtype``.
    ``res_x`` adds the residual input (a ``res=True`` model)."""
    k = lambda name: tparams[name]["kernel"]
    b = lambda name: tparams[name]["bias"]
    g1 = g1.to(dtype)
    conv = lambda t, name: _lrelu(_conv_same(t, k(name), b(name)))

    c1g = conv(conv(g1, "conv1_1"), "conv1_2")
    out = _tail(tparams, _mid_levels(tparams, _group_max(c1g)), c1g)
    if res_x is not None:
        out = out + res_x.to(dtype)
    return out


def unet_hybrid_forward(tparams: dict, x: torch.Tensor, res: bool = False,
                        dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """UNetSeeInDark through the hybrid form, ``[N, 4, H, W]`` in and float32
    ``[N, 4, H, W]`` out: s2d -> :func:`unet_hybrid_forward_packed` -> d2s."""
    g = s2d(x.to(dtype))
    return d2s(unet_hybrid_forward_packed(tparams, g, g if res else None, dtype)).float()
