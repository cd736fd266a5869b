"""The card's int8 convolution and matmul rate against bf16 at the
dense-s2d layer shapes (counterpart of ``tools/bench_int8.py``).

The int8 side is the W8A8 path's own convolution,
``ops/int8conv.py::conv3x3_int8`` (im2col + ``torch._int_mm``, cuBLASLt's
s8 x s8 -> s32 GEMM), and ``int_mm`` for the matmul cases; the bf16 side is
``F.conv2d`` (cuDNN, ``channels_last``) and ``torch.matmul``. Each step
feeds its output back into the next (int8: shift-requant ``acc >> 7`` to
s8; C != D folds the output onto the carry), so K steps chain as the JAX
tool's ``lax.scan`` does.

Timing: K chained steps between two CUDA events, one readback after them,
the median of ``--repeats`` runs after one warm-up run (perf_counter on the
host with ``--cpu``).

Usage (from the repository root; on the card unless ``--cpu``):

    python -m pnnp_tpu_torch.tools.bench_int8 [--small] [--cpu]

Prints the device on stderr and one JSON line per case with the JAX tool's
keys; :func:`main` returns the rows.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

K_CHAIN = 24
REPEATS = 6

# (name, kind, shape): the JAX tool's cases; conv shapes (H, W, C, D),
# matmul shapes (M, K, N)
CASES = (
    ("conv3x3_128x128@712x1064", "conv", (712, 1064, 128, 128)),
    ("conv3x3_16x128@712x1064", "conv", (712, 1064, 16, 128)),
    ("conv3x3_64x64@356x532", "conv", (356, 532, 64, 64)),
    ("matmul_378k_128_128", "matmul", (712 * 532, 128, 128)),
    ("matmul_378k_1152_128", "matmul", (712 * 532, 1152, 128)),
)
SMALL_CASES = (
    ("conv3x3_32x32@64x64", "conv", (64, 64, 32, 32)),
    ("matmul_4k_128_128", "matmul", (4096, 128, 128)),
)


def median_ms(run, K: int, repeats: int, dev) -> float:
    """Median ms per call of ``run()``, which queues ``K`` chained calls and
    returns a tensor read back after them; one warm-up run first."""
    import torch

    float(run().float().sum())
    times = []
    for _ in range(repeats):
        if dev.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            y = run()
            end.record()
            float(y.float().sum())
            times.append(start.elapsed_time(end) / K)
        else:
            t0 = time.perf_counter()
            float(run().float().sum())
            times.append((time.perf_counter() - t0) * 1e3 / K)
    return statistics.median(times)


def _chain(step, x0, K):
    def run():
        x = x0
        for _ in range(K):
            x = step(x)
        return x
    return run


def conv_case(H, W, C, D, dev, K=K_CHAIN, repeats=REPEATS):
    """Chained 3x3 SAME conv, bf16 (cuDNN) against int8 (im2col + int_mm,
    requantized to s8): (bf16 ms, int8 ms, FLOPs)."""
    import torch
    import torch.nn.functional as F

    from pnnp_tpu_torch.ops.int8conv import conv3x3_int8

    assert D >= C, "the fold-back feedback needs D >= C"
    flops = 2 * H * W * 9 * C * D
    g = torch.Generator(device=dev).manual_seed(0)
    cl = torch.channels_last
    xb = torch.randn((1, C, H, W), generator=g, device=dev).to(torch.bfloat16, memory_format=cl)
    kb = (torch.randn((D, C, 3, 3), generator=g, device=dev) * 0.05).to(torch.bfloat16,
                                                                        memory_format=cl)

    def step_b(t):
        acc = F.conv2d(t, kb, padding=1)
        return acc if D == C else t + acc[:, :C]

    xi = torch.randint(-127, 128, (1, C, H, W), generator=g, device=dev,
                       dtype=torch.int8).contiguous(memory_format=cl)
    ki = torch.randint(-4, 5, (D, C, 3, 3), generator=g, device=dev, dtype=torch.int8)

    def step_i(t):
        q = (conv3x3_int8(t, ki) >> 7).clamp_(-127, 127)
        if D != C:
            q = (t.int() + q[:, :C]).clamp_(-127, 127)
        return q.to(torch.int8)

    with torch.no_grad():
        return (median_ms(_chain(step_b, xb, K), K, repeats, dev),
                median_ms(_chain(step_i, xi, K), K, repeats, dev), flops)


def matmul_case(M, K_, N, dev, K=K_CHAIN, repeats=REPEATS):
    """Chained matmul, bf16 against int8 (``int_mm``): (bf16 ms, int8 ms,
    FLOPs)."""
    import torch
    import torch.nn.functional as F

    from pnnp_tpu_torch.ops.int8conv import int_mm

    flops = 2 * M * K_ * N
    g = torch.Generator(device=dev).manual_seed(0)
    xb = torch.randn((M, K_), generator=g, device=dev).to(torch.bfloat16)
    wb = (torch.randn((K_, N), generator=g, device=dev) * 0.05).to(torch.bfloat16)

    def step_b(t):
        acc = t @ wb
        return acc if N == K_ else t + F.pad(acc, (0, K_ - N))

    xi = torch.randint(-127, 128, (M, K_), generator=g, device=dev, dtype=torch.int8)
    wi = torch.randint(-4, 5, (K_, N), generator=g, device=dev, dtype=torch.int8)

    def step_i(t):
        q = (int_mm(t, wi) >> 7).clamp_(-127, 127)
        if N != K_:
            q = (t.int() + F.pad(q, (0, K_ - N))).clamp_(-127, 127)
        return q.to(torch.int8)

    with torch.no_grad():
        return (median_ms(_chain(step_b, xb, K), K, repeats, dev),
                median_ms(_chain(step_i, xi, K), K, repeats, dev), flops)


def measure(cases, dev) -> dict:
    """``{case: (bf16 ms, int8 ms, FLOPs)}`` of each case."""
    out = {}
    for name, kind, shape in cases:
        fn = conv_case if kind == "conv" else matmul_case
        out[name] = fn(*shape, dev)
    return out


def run_cases(cases, dev) -> list:
    """Measure ``cases`` and print each as the JAX tool's JSON line."""
    rows = []
    for name, (dt_b, dt_i, flops) in measure(cases, dev).items():
        row = {"case": name, "bf16_ms": round(dt_b, 3), "int8_ms": round(dt_i, 3),
               "bf16_tflops": round(flops / dt_b / 1e9, 1),
               "int8_tops": round(flops / dt_i / 1e9, 1),
               "int8_speedup": round(dt_b / dt_i, 2)}
        print(json.dumps(row), flush=True)
        rows.append(row)
    return rows


def main(argv=None, device=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--small", action="store_true", help="CPU-sized shapes (wiring)")
    ap.add_argument("--cpu", action="store_true")
    a = ap.parse_args(argv)

    import torch

    from pnnp_tpu_torch.utils.device import card_label, resolve_device

    dev = torch.device("cpu") if a.cpu else resolve_device(device)
    print(f"devices: {dev} ({card_label(dev)})", file=sys.stderr)
    return run_cases(SMALL_CASES if a.small else CASES, dev)


if __name__ == "__main__":
    main()
