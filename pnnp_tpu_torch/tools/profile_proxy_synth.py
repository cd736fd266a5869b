"""Composed-marginal cost profile of the ``pw_iso_2stage`` proxy's sample
(counterpart of ``tools/profile_proxy_synth.py``).

The proxy synth stage (``make_proxy_synth`` -> ``PixelWiseISOProxy.sample``)
is the PNNP step's extra over the physics step. This rebuilds the sample
outside the module from its parameters (:func:`mlp` -> ``HeadParams``,
:func:`iso_feat`, the uniforms, the shot noise through ``ops/poisson.py``,
the lookups through ``QuantileHead.quantile`` / ``quantile_dot``) and times
variants of it, each adding a mechanism:

  u        the draws only (u_px, c_px, the s0 normal, u_row, c_row)
  shot     + the exact Poisson shot (``ops/poisson.py``)
  core     + the PWL core lookup (``quantile``: an f32-knot gather, no tail)
  full     + the Laplace tail, the s0 smoothing and the row stage, with the
           module's own lookup (``lookup='dot'`` by default): the production
           sample, drawn from the generator in the module's order, so that
           it equals ``PixelWiseISOProxy.sample`` on the same generator state
  fixedk   full with the pixel lookup's indices frozen (u = 0.5): full -
           fixedk is the cost of the data-dependent gather
  dot      full with the pixel lookup as ``quantile_dot``, the law the JAX
           package adopted (a gather of bf16-rounded knots here; with the
           default ``lookup='dot'`` it is full's own)

beside the production ``sample`` for reference, then the dot-vs-gather
probe: ``quantile`` against ``quantile_dot`` on the same draws, its max
error relative to the draw's max (bf16 knot rounding bounds it by ~2e-3).
The JAX tool predates the s0 smoothing and the zero-mean heads; the
rebuild follows the module as it stands.

Defaults: 8 x 4 x 256^2 clean U(0, 0.3) (``--small``: 32^2), d = 256, ISO
1600. Timing: ``--iters`` calls between two CUDA events, each output summed
into one accumulator read back once, the median of ``--repeats``
(``bench_int8.median_ms``; the host clock with ``--cpu``).

Usage (from the repository root; on the card unless ``--cpu``):

    python -m pnnp_tpu_torch.tools.profile_proxy_synth [--d 256] [--batch 8] [--iters 8] [--small] [--cpu]

:func:`main` returns ``{"production_ms", "rows": [{"variant", "ms",
"marginal_ms"}], "dot_vs_gather"}``.
"""

from __future__ import annotations

import argparse
import sys

import torch
import torch.nn.functional as F

from pnnp_tpu_torch.models.proxy import HeadParams, PixelWiseISOProxy, QuantileHead
from pnnp_tpu_torch.ops.poisson import poisson_sample
from pnnp_tpu_torch.tools.profile_prefix import calls_ms
from pnnp_tpu_torch.utils.device import card_label, resolve_device

VARIANTS = ("u", "shot", "core", "full", "fixedk", "dot")
ISO = 1600.0
DOT_BOUND = 2e-3  # the bf16 knot rounding bound of the JAX tool's probe
PROXY_SEED, CLEAN_SEED, PROBE_SEED = 1, 0, 4


def mlp(proxy: PixelWiseISOProxy, feat, scope: str) -> HeadParams:
    """A head's ``HeadParams`` from its weights (``QuantileHead.forward``
    outside the module; not centred)."""
    head = getattr(proxy, scope)
    h = feat
    for i in range(head.nb):
        fc = getattr(head, f"fc{i}")
        h = F.silu(F.linear(h, fc.weight, fc.bias))
    return QuantileHead.from_raw(F.linear(h, head.bins.weight, head.bins.bias))


def iso_feat(proxy: PixelWiseISOProxy, iso: float, n: int, dev):
    """``[K(iso), log(iso / 1600)]`` per example, ``[n, 2]``, in the module's
    float32 arithmetic."""
    iso = torch.full((1,), iso, device=dev)
    k = proxy.iso2k[0] * iso + proxy.iso2k[1]
    return torch.stack([k, torch.log(iso / 1600.0)], dim=-1).expand(n, 2)


def heads(proxy: PixelWiseISOProxy, feat):
    """The pixel and row heads as the module samples them (centred where
    ``zero_mean``)."""
    hps = [mlp(proxy, feat, s) for s in ("pixel_stage", "row_stage")]
    return [QuantileHead.center(hp) for hp in hps] if proxy.zero_mean else hps


def pixel_lookup(proxy: PixelWiseISOProxy, which: str, hp: HeadParams, u, c):
    """The pixel head's draw in variant ``which`` (core, full, fixedk, dot)
    at the uniforms ``u`` (the tail chosen by ``c``)."""
    if which == "core":
        return QuantileHead.quantile(hp, u)
    if which == "fixedk":
        return QuantileHead.quantile(hp, torch.full_like(u, 0.5), c) + u * 1e-20
    if which == "dot" or proxy.lookup == "dot":
        return QuantileHead.quantile_dot(hp, u, c)
    return QuantileHead.quantile(hp, u, c)


def build(proxy: PixelWiseISOProxy, which: str, iso: float = ISO):
    """Variant ``which`` as ``f(generator, clean) -> noise`` (normalized)."""
    span = proxy.wp - proxy.bl

    def f(g, clean):
        n, c, h, _ = clean.shape
        feat = iso_feat(proxy, iso, n, clean.device)
        hp_px, hp_row = heads(proxy, feat)
        K = feat[:, 0].reshape(n, 1, 1, 1)
        total = torch.zeros_like(clean)
        if which != "u":
            clean_adu = clean.clamp_min(0.0) * span
            total = poisson_sample(g, clean_adu / K.clamp_min(1e-6)) * K - clean_adu

        def uniform(shape, lo=0.0, hi=1.0):
            return torch.rand(shape, generator=g, device=g.device) * (hi - lo) + lo

        u_px = uniform(clean.shape, 1e-6, 1 - 1e-6)
        c_px = uniform(clean.shape)
        s0 = (torch.randn(clean.shape, generator=g, device=g.device) if proxy.smooth_s0 > 0
              else torch.zeros_like(clean))
        u_row = uniform((n, c, h, 1), 1e-6, 1 - 1e-6)
        c_row = uniform((n, c, h, 1))
        if which == "u":
            return (u_px + c_px + s0 + u_row + c_row) / span
        if which == "shot":
            return total / span
        total = total + pixel_lookup(proxy, which, hp_px, u_px, c_px)
        if which == "core":
            return total / span
        if proxy.smooth_s0 > 0:
            total = total + proxy.smooth_s0 * s0
        row = QuantileHead.quantile(hp_row, u_row, None if which == "fixedk" else c_row)
        return (total + row) / span

    return f


def dot_vs_gather(proxy: PixelWiseISOProxy, shape, dev) -> float:
    """``quantile`` against ``quantile_dot`` of the pixel head on the same
    draws: the max error over the draw's max."""
    g = torch.Generator(device=dev).manual_seed(PROBE_SEED)
    hp = mlp(proxy, iso_feat(proxy, ISO, shape[0], dev), "pixel_stage")
    u = torch.rand(shape, generator=g, device=dev) * (1 - 2e-6) + 1e-6
    c = torch.rand(shape, generator=g, device=dev)
    ref = QuantileHead.quantile(hp, u, c)
    dot = QuantileHead.quantile_dot(hp, u, c)
    return float((ref - dot).abs().max() / (ref.abs().max() + 1e-9))


def setup(d: int, batch: int, small: bool, dev):
    """(the seeded proxy, the clean batch [batch, 4, hw, hw])."""
    hw = 32 if small else 256
    proxy = PixelWiseISOProxy(d=d, generator=torch.Generator().manual_seed(PROXY_SEED)).to(dev)
    g = torch.Generator(device=dev).manual_seed(CLEAN_SEED)
    return proxy, torch.rand((batch, 4, hw, hw), generator=g, device=dev) * 0.3


@torch.no_grad()
def main(argv=None, device=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=8)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--small", action="store_true", help="8x4x32x32 clean")
    ap.add_argument("--d", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8)
    a = ap.parse_args(argv)

    dev = torch.device("cpu") if a.cpu else resolve_device(device)
    print(f"devices: {dev} ({card_label(dev)})", file=sys.stderr)
    proxy, clean = setup(a.d, a.batch, a.small, dev)
    iso = torch.tensor([ISO], device=dev)
    g = torch.Generator(device=dev).manual_seed(9)
    time = lambda fn: calls_ms(lambda: fn(g, clean), a.iters, a.repeats, dev)
    prod = time(lambda g, c: proxy.sample(c, iso, g))
    print(f"production proxy.sample           : {prod:7.2f} ms", flush=True)
    rows, prev = [], 0.0
    for which in VARIANTS:
        ms = time(build(proxy, which))
        print(f"variant {which:7s}: {ms:7.2f} ms   (marginal vs prev {ms - prev:+7.2f})",
              flush=True)
        rows.append({"variant": which, "ms": ms, "marginal_ms": ms - prev})
        prev = ms
    err = dot_vs_gather(proxy, clean.shape, dev)
    print(f"dot-vs-gather max rel err: {err:.3e} (bf16 knot rounding bound ~{DOT_BOUND:g})",
          flush=True)
    return {"production_ms": prod, "rows": rows, "dot_vs_gather": err}


if __name__ == "__main__":
    main()
