#!/usr/bin/env python3
"""Smoke run of the PyTorch/H100 port (``pnnp_tpu_torch``) on one card.

Run from the root of the repository, with no arguments:

    python3 chip_smoke.py

Phases, each failing loudly (an exception ends the run with a non-zero exit
and no result line):

1. the card's name and power limit; build every CUDA source of the port
   (one ``nvcc`` per source, all started together);
2. every kernel against its plain PyTorch version on the card, at the test
   shapes (both routes of the SSIM kernel wherever each applies) and at the
   full Sony and IMX686 frames, run to run bit-identity, and a bright
   low-variance frame against a float64 evaluation;
3. the port's main path at full width: ``pnnp_tpu_torch.trainer.main
   --mode eval`` over a synthetic 2848x4256 SID fixture (2 scenes) with a
   seeded N(0, 0.02) nf=32 UNetSeeInDark checkpoint, the Sony values of
   ``runfiles/SonyA7S2/ELD.yml``; the kernels' launch counts (in all and by
   route) are read around exactly that run, and one frame's SSIM is
   recomputed by the plain version;
4. the training half of the main path: ``pnnp_tpu_torch.trainer.main
   --mode train`` on a 4-scene 2848x4256 fixture with the Sony values of
   ``runfiles/SonyA7S2/ELD.yml`` (``Raw_Dataset``, ``pgrq``, nf=32, 8 crops
   of 512x512 per step, ``T: 3``), cut to 2 epochs (8 steps) at a fixed lr
   of 2e-4, an eval leg every epoch over the 4 scenes placed in the
   ``SID_Dataset`` 250 split, then the ``evaltest`` sweep. Asserted: 8
   finite steps and no aborted epoch, params moved, f32 master params on
   the card with bf16 convolutions, ``last``/``best`` load back, 4 frames
   per eval leg, ``best`` written at epoch 1 and reloaded at the period
   boundary, and 12 SSIM launches, all ``hopper``; then one f32 step at
   nf=4 on 8x32^2 on the card against the same step on the CPU, and the
   bf16 step's gradients against the f32 ones on the card;
5. the proxy at PNNP.yml's width (d=1024) on the card against the CPU:
   ``quantile`` / ``quantile_dot``, the loss and its gradients, and the
   sample's moments at the recipe shape (8 x 4 x 512 x 512) against the
   closed form (tests/test_torch_cuda_proxy.py runs the same checks);
6. the ISO ladder: ``pnnp_tpu_torch/tools/validate_proxy.py`` at the budget
   of tests/test_proxy_iso_ladder.py (4000 steps, d=256, 8 x 32^2), for
   two seeds (``tools/ladder_spread.py``): the trained ISOs held to that
   test's KLD bars and the trained-12800 row KLD to twice the JAX
   package's largest reading (``LADDER_ROW_12800_BAR``) in every run, the
   row law's std and support printed, the held-out ISO 6400 reported
   against its bar;
7. the paper's method (``runfiles/SonyA7S2/PNNP.yml``) on a 4-scene
   2848x4256 fixture: ``pnnp_tpu_torch.trainer_nf.main --kind proxy`` (its
   ``arch_proxy`` at d=1024, SID pairs, one 512^2 crop per step, 2 epochs;
   finite NLL, a KLD line per epoch, the checkpoint, ms per step and peak
   memory), then ``pnnp_tpu_torch.trainer.main --mode train`` of PNNP.yml
   (UNetSeeInDark nf=32, ``Proxy_Dataset``, 8 crops of 512^2, 2 epochs at
   its lr held fixed, an eval leg per epoch over the SID 250 split, then
   ``evaltest``) driven by that checkpoint: the proxy drew the noise of
   every step, finite losses, moved params, 12 SSIM launches, all
   ``hopper``;
8. the IMX686 camera and the paper's baselines (``phase_baselines``):
   ``runfiles/IMX686/PNNP.yml --mode train`` on a 3472x4624 LRID fixture
   (59 info entries on 2 frames, an ISO-6400 bias library and its -hot
   twin; ``IMX686_Proxy_Dataset``, the proxy at its seed-0 init, d=1024;
   nf=32, 12 crops of 512^2; the runfile's ``small`` quarter, one epoch at
   its lr held fixed): the proxy drew every step's noise at one dgain of
   {1, 2, 4, 8, 16} per batch and ISO 6400, no eval was illuminance-
   corrected, every SSIM launch ``hopper`` at ``[1736, 9248]``, one per
   frame (a fast-eval leg, then ``evaltest``); ``IMX686/PMN.yml --mode
   trainonly`` (bias pastes, HighBitRecovery on the card touching only the
   pasted crops, and against the CPU on one field, SNA every step); then
   ``SonyA7S2/PMN.yml --mode train`` (``Mix_Dataset``, host HBR on the
   pastes, an eval leg per epoch over the SID 250 split, ``evaltest``) and
   ``SonyA7S2/SFRN.yml --mode trainonly`` on a 2848x4256 SID fixture with an
   ISO-1600 bias library: finite losses, moved params; then their timings
   (``phase_baseline_timings``): the bf16 step with the Mix synth at Sony
   8x512^2 and IMX686 12x512^2 and with the SFRN synth at 8x512^2, split;
   the bf16 eval step at the IMX686 frame with its SSIM share; the loaders
   at 4 workers, alone and feeding the step, for ``IMX686_Dataset``,
   ``IMX686_Mix_Dataset``, ``Mix_Dataset`` and ``SFRN_Dataset``;
9. NoiseFlow on the same fixtures (``phase_noiseflow``):
   ``pnnp_tpu_torch.trainer_nf.main --kind noise_flow`` of
   ``SonyA7S2/NoiseFlow.yml`` (SID pairs, 256 crops of 64^2 per step) and
   ``IMX686/NoiseFlow.yml`` (LRID pairs, 384 crops, its ``small`` quarter),
   2 epochs at the runfiles' lr held fixed: the production arch string on
   the card, the epoch NLLs finite, the NLL on a fixed train batch below the
   init flow's, every epoch scored by the
   held-out KLD, ``best`` the min-KLD epoch, ``batch_stats`` in the
   checkpoint and moved; then ``SonyA7S2/NF.yml`` and ``IMX686/NF.yml``
   ``--mode train`` on those checkpoints (``NF_Syn``, nf=32, 8 / 12 crops of
   512^2, one epoch, an eval leg, ``evaltest``): the frozen flow drew every
   step's noise, params moved, the eval PSNRs finite, every SSIM launch
   ``hopper``; their timings (the flow's NLL step at 256 x 64^2 with a
   profile, its sampling at 8 x 512^2, the bf16 NF.yml step, split); the
   flow on the card against the CPU (production arch, 8 x 64^2, off-init
   weights: z, log-det, inverse, the train-mode NLL and its gradients); and
   ``pnnp_tpu_torch/tools/validate_nf.py`` at the budget of
   tests/test_nf_kld_parity.py (4000 steps, patch 16, batch 4), held to its
   bars: it runs in a process of its own beside phase 6, since both are
   bound by the host;
10. the recipe A/B (``pnnp_tpu_torch/tools/ab_proxy_vs_physics.py``) at
   full width (patch 512, batch 8, nf 32, d 256) with its budget cut
   (``AB_ARGS``), in a process of its own beside phase 6: held to
   tests/test_ab_recipe.py's bars (8 finite rows, the held-out ISO, |mean
   delta| <= 0.3 dB, worst >= -0.6, both arms 4 dB over the input at ratio
   300 and ISO >= 6400);
11. the eval's other paths (``phase_eval_paths``) on a 2-scene 2848x4256
   SID fixture with phase 3's runfile and checkpoint: ``--mode eval`` with
   ``rgb_metrics`` and figures on (per frame one ``hopper`` launch for the
   raw SSIM and two ``generic`` ones for the sRGB SSIM of input and
   output; frame 0's sRGB PSNR / SSIM recomputed by the plain versions on
   the card and on the CPU; ``rgb_quality`` timed; the figures checked on
   disk, or their one logged skip without matplotlib), with
   ``disable_fused_eval`` (each frame against the fused step within the
   bf16 eval limits), ``pnnp_tpu_torch.trainer_led.main`` (each PSNR the
   plain PSNR of the corrected input, and the correction moved it), and
   ``Trainer.predict`` on a full mosaic (20 tiles of 512^2: bf16 timed,
   median of 5; f32 on the card against f32 on the CPU on a 1024x1536
   corner, to 1e-4 of the max); each run's SSIM launches by route;
12. timings with CUDA events after warm-up: the fused eval step in bf16 and
   in f32 at the full frame (median per call, plus a torch.profiler
   breakdown by kernel and the device's idle share), each kernel route
   (mean over back-to-back launches, the two routes in turns) at the Sony
   and IMX686 frames, and ``generic`` at both sRGB frames of
   ``rgb_quality``, against its bound and its plain version, and the
   train step at 8x512^2 ``pgrq`` in bf16 and f32 (median of 10 after 3
   warm-ups, the split synth / forward + backward / Adam, a profiler
   breakdown with the idle share, the FLOP bound) and the host loader's
   time per batch (one full frame -> 8 crops): on one thread, and at the
   runfile's 4 workers over 32 batches, alone and feeding the train step;
   and the proxy: its synth beside the physics synth at 8 x 512^2 (in
   turns), the bf16 train step with the proxy synth (split, peak memory),
   the proxy NLL step at one 512^2 crop (d=1024, with a profile) and at the
   ladder's shape (d=256), each with its peak memory and forward FLOP bound.

13. the packed forms and the W8A8 path: the hybrid packed forward
   in f32 (TF32 off) against the NCHW UNet on the card (1e-5 of the max);
   the int8 convolutions' int32 accumulators bit-equal card against CPU at
   every quantizable layer's channel counts (nf=32; conv9_1's K = 585); the
   int8 forward card against CPU on the same qparams (f32);
   ``pnnp_tpu_torch/tools/validate_int8.py`` at its default budget beside
   the ISO ladder (disjoint calibration at pct 99.95 and 100, then the
   trainer's from-eval x3 at 99.95); ``trainer.main --mode eval --int8``
   with the net it trained, over a 5-scene 2848x4256 SID fixture (3
   calibration frames, the first 2 served bf16; 3 served int8; every frame
   within 0.5 dB / 0.05 SSIM of the bf16 fused step, while the seeded init
   scores more than 0.5 dB away; SSIM launches under ``int8``); and the
   same-call A/Bs that set the memory-format defaults: the bf16 fused eval
   step through the UNet in NCHW memory and in ``channels_last`` memory (the
   bf16 default) at both frames, with the W8A8 step beside them; the bf16
   train step at 8 x 512^2 ``pgrq`` through the same two; the f32 eval and
   train steps in NCHW against ``channels_last``.

14. several devices (ROADMAP 1.16, ``phase_multidevice``): 2 ``gloo``
   ranks, spawned, both on cuda:0 (NCCL refuses two ranks on one card;
   the backend is printed): ``trainer.main --mode train`` of ELD.yml (a
   2-scene 2848x4256 fixture, one epoch: data-parallel steps, each rank
   keeping 4 of every frame's 8 crops, and the eval legs and ``evaltest``
   through the width-sharded fused step, the SSIM kernel launched on every
   rank's slab; launches under ``sharded``) and ``trainer_nf --kind
   noise_flow`` of NoiseFlow.yml (one epoch, BatchNorm moments over both
   ranks), each ending with equal parameter (and running-statistic) sums
   on both ranks; the sharded
   fused eval at the full Sony and IMX686 frames (nf=32, bf16
   ``channels_last``) held to the single-device step on the same card
   (PSNR 1e-3, SSIM 1e-5) and timed beside it, with and without the frame
   gather; the data-parallel bf16 train step at 8 x 512^2 ``pgrq``, its
   params bit-identical across the ranks after 3 steps, timed beside the
   one-rank step (``pnnp_tpu_torch/tools/multidevice.py``'s checks); and
   the per-rank SSIM slabs ``[1424, 4312]`` and ``[1736, 4696]`` on the
   ``hopper`` route against the plain version, timed against their bound.

15. the flow library and the eval tools and demos (ROADMAP 1.12, 1.17):
   every bijector no runfile reaches (``models/flows/{spline,basic,
   conditional}.py``, ``AffineCouplingV2``, ``SignalDependantNS``) and
   ``SdnModelScale`` on the card against the CPU on one seeded batch
   (``bijector_card_check``, beside phase 9's flow check: within 1e-5 of
   the largest CPU magnitude); ``pnnp_tpu_torch/tools/eval_fullres.py`` in
   its default and ``--int8`` modes at both frames, 2 frames
   chained (SSIM launches under ``fullres``), one of its Sony frames
   recomputed by the plain SSIM and PSNR, and ``tools/bench_eval_loop.py``
   over 4 Sony frames, sync and pipelined (launches under ``eval_loop``),
   in this process (``phase_tools``); ``tools/validate_noise_model.py`` at
   400k samples (every row's ``kl_sym`` <= 5e-3) and ``tools/demo_train.py``
   then ``tools/demo_pnnp_pipeline.py`` at 200 steps of 8 x 128^2 (a
   positive PSNR gain over the input and over the untrained net, the proxy's
   KLD falling), each in a process of its own beside phase 6.

16. the card's Poisson law (ROADMAP section 3.2, ``phase_poisson``, after
   phase 5): ``pnnp_tpu_torch/tools/check_poisson.py``'s sampler against
   ``scipy.stats.poisson`` at lam in {1, 4, 16, 23, 64, 100} on the card
   (2^22 draws) and the CPU (2^20): mean and variance within 2%, the pmf KLD
   within 4x its floor; each card draw uncorrelated with the next call's
   uniform at the same element (the stream reserve of ``ops/poisson.py``;
   bare ``torch.poisson`` reported beside it); ``validate_noise_model``'s
   IMX686 ISO 100 row split by code (p, g, r, q, pgrq) over seeds 0-7 at
   400k samples on the card, and its pgrq row with bare ``torch.poisson``
   and on the CPU: the card's pgrq median at most the CPU's largest.

17. the proxy research tools (ROADMAP 1.19, ``phase_proxy_tools``, after
   phase 6, whose last ladder run saves its params): ``diagnose_proxy_fit``
   on that trained proxy, card against CPU (closed-form columns within
   1e-5), and ``oracle_row_deconv`` / ``oracle_proxy_family`` at 200 steps
   at ISO 12800, their KLDs and wall times.

18. the int8 serving tools (ROADMAP 1.20, ``phase_int8_tools``, after phase
   13's A/Bs): ``ablate_int8_quantset`` (every subset),
   ``profile_prefix_int8`` (the full prefix within 10% of phase 13's W8A8
   eval step at the Sony frame, each of the seven marginals above -5% of
   it),
   ``bench_int8`` (every case) and ``int8_roofline`` (the walk's FLOP
   inventory equal to the JAX tool's table; the int4 probe's JSON form).

19. the real-data CLIs (ROADMAP 1.18, ``phase_golden``, after phase 15):
   full-width synthetic SID evaltest (81 scenes over the x100 / x250 / x300
   splits, three distinct raw pairs linked) and ELD (one scene, ISOs 800 /
   1600 / 3200 at ratios 100 and 200) trees, indexed by
   ``tools/get_dataset_infos.py``; a seeded nf=32 UNetSeeInDark saved as a
   reference ``.pth``; ``tools/golden_parity.py --config SonyA7S2_PNNP``
   on the card against BASELINE.md's numbers (exit 1, 5 sweeps, ``fail``)
   and against that run's own numbers (exit 0): 174 ``hopper`` launches
   under ``golden``.

20. the bf16 forward and proxy-step profilers and the serving A/Bs (ROADMAP
   1.21, ``phase_profile_tools``, after phase 12's timings, which it holds
   against): ``profile_prefix``, ``profile_layers`` and ``profile_ablate``
   in both forms (``channels_last``, ``packed``) at the Sony frame: the full
   prefix within 10% of its one-piece anchor, each band's marginal above -5%
   of it, the ``channels_last`` anchor at or below phase 12's bf16 eval step;
   no layer above 105% of the dense bf16 peak; each ablated forward at or
   below 105% of the base; ``profile_proxy_step`` at 8 x 512^2, d=1024
   (``step`` within 10% of an independent median of the same call, the
   physics control within 10% of phase 12's bf16 ``pgrq`` step, each
   marginal above -5% of ``step``);
   ``profile_proxy_synth`` (dot-vs-gather within 2e-3, the rebuilt ``full``
   sample equal to the module's); ``bench_halfdense`` (its bf16 error
   within 4x the dense hybrid's, both against the f32 hybrid);
   ``bench_serving_variants`` over 24 Sony frames (the eager loop, k frames
   per call, CUDA graphs of 1, 2, 4 frames bit-equal to the loop; int8
   within 0.08 relative L2).

21. the proxy NLL's kernel pair (``kernels/proxy_core.py``,
   ``csrc/proxy_core.cu``; ``phase_proxy_core``, after phase 12's proxy
   timings) at the main path's shape, PNNP.yml's proxy at ISO 800 and
   12800: the pixel head on one [1, 4, 512, 512] frame, the row head on its
   2,048 row means (one s a value), each head's core and knot gradient
   against float64 ``_core_conv`` (``PROXY_CORE_TOL``, as
   tests/test_torch_cuda_proxy_kernel.py), two launches bit-identical, the
   forward (with its sort of the values) and the backward kernel timed
   against the bound of that input over the full grid and over the pairs
   the kernels walked (their ``proxy.core_pairs_walked``).
   The kernels' launches are counted on every path of this script that runs
   the proxy NLL on the card (phases 5, 6, 7, 10's A/B, 15's
   ``demo_pnnp_pipeline``, 17, 12's proxy timings): each at least one of
   each kernel, phase 5's loss check exactly 2 and 2, the proxy trainer 2
   backward launches a step, PNNP.yml's ``--mode train`` (the synth) none.

Phase 2 also holds the ``generic`` route at its own edges
(``GENERIC_SHAPES``: C = 1, 2, 3, 5, 8, 16, rows of ``W*C % 4 != 0`` lanes,
unaligned views, strip and warp-column edges at C = 3), at a C = 3 drift
frame and at the sRGB frames of ``rgb_quality`` (``SRGB_SONY``,
``SRGB_IMX686``), and its grid against the Python mirror
(``kernels/ssim.py::generic_grid``); phase 12 times it at both sRGB frames
and at the two raw frames.

Output: one ``timings`` JSON line, one ``kernels`` JSON line (a row per
SSIM route: ``ssim`` is the ``hopper`` route of the main path, timed at the
raw Sony frame; ``ssim_generic`` the route of ``rgb_quality``, timed at the
sRGB Sony frame; each with ``by_shape``, its time, bound and share at every
frame phase 12 times it; ``launches`` sums the eval,
the train, the PNNP, the four baseline, the two NF.yml, the rgb, unfused,
LED, predict and int8 runs, the two ranks' ``sharded``
path, phase 15's ``fullres`` and ``eval_loop`` runs and phase 19's
``golden`` sweeps;
``launches_by_path`` keeps each; and a ``proxy_core`` row, phase 21's: its
forward and backward launches by path and in all, its largest errors, and
its times, bound and share for the pixel head at ISO 800 with
``by_shape`` for both heads at both ISOs),
the ``nvidia-smi``
name/power-limit line, and last
``{"ok": true, "device": {...}}``. Exits non-zero without CUDA.
"""

from __future__ import annotations

import importlib.util
import json
import math
import os
import re
import pickle
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

# H100 SXM peaks (NVIDIA data sheet, 700 W): device memory and fp32 outside
# the tensor cores. The SSIM kernel's work is fp32 CUDA-core arithmetic.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
BF16_FLOP_PER_S = 989e12  # dense, tensor cores
TOL = 1e-4
SONY, IMX686 = (1424, 2128, 4), (1736, 2312, 4)  # packed full frames [H, W, C]
STRIP = 16  # the hopper route's shortest strip (csrc/ssim.cu MIN_STRIP)
SRGB_SONY, SRGB_IMX686 = (2848, 4256, 3), (3472, 4624, 3)  # fast_isp's sRGB full frames
KERNEL_SHAPES = [(7, 7, 4), (70, 96, 4), (71, 96, 4), (96, 131, 3),
                 (201, 140, 4), SONY, IMX686,
                 # strip edges, and widths one pixel into a warp's halo / the next warp
                 (STRIP + 6, 121, 4), (STRIP + 7, 127, 4), (2 * STRIP + 5, 126, 4),
                 # rgb_quality's frames (the generic route at C = 3)
                 SRGB_SONY, SRGB_IMX686]
# the generic route's edges (tests/test_torch_cuda_kernels.py GENERIC_SHAPES):
# every lane shape (P = 4, 2, 1 pixels a lane), 4-byte copies (W*C % 4 != 0)
# beside 16-byte ones, several warp columns with a ragged end, and at C = 3
# the strip edges and widths into a warp's halo and the next warp
GENERIC_SHAPES = [(70, 252, 1), (71, 97, 1), (70, 130, 2), (37, 97, 2),
                  (40, 132, 5), (40, 77, 5), (40, 130, 8), (30, 64, 16), (29, 61, 16),
                  (STRIP + 6, 121, 3), (STRIP + 7, 128, 3), (2 * STRIP + 5, 127, 3)]
UNALIGNED = (37, 131)  # [H, W] of the views 4 bytes off 16-byte alignment, C = 3 and 4
DRIFT = (1424, 256, 4)  # bright low-variance frame for the running-sum check
DRIFT3 = (1424, 4256, 3)  # the same at C = 3: the generic route's strips of 49 rows
MOSAIC_H, MOSAIC_W = 2848, 4256  # Sony A7S2 full frame, packed [1424, 2128, 4]
SSIM_OPS_PER_WINDOW = 89  # 5 separable 7+7-tap sums (60) + the SSIM formula (29)
TRAIN_SCENES, TRAIN_EPOCHS = 4, 2  # batch_size 1: one frame (8 crops) per step
TRAIN_LR = 2e-4  # ELD.yml's learning_rate, held fixed (WarmupCosine is 0 here)
CROPS, PATCH = 8, 512
PNNP_LR = 1e-4  # PNNP.yml's learning_rate, held fixed
PROXY_D = 1024  # PNNP.yml's arch_proxy.d
NF_LR = 1e-3  # the proxy trainer's fixed lr
# tests/test_proxy_iso_ladder.py:27's budget, at the JAX tool's defaults, and
# the seeds of the ladder's runs (each a fresh init draw and training stream;
# two since phase 14 joined: the ladder runs its seeds one after another and
# is the longest of the host-bound phases, 80 s a seed)
LADDER_ARGS = ["--steps", "4000", "--eval-frames", "16", "--d", "256", "--patch", "32",
               "--batch", "8"]
LADDER_SEEDS = "0,1"
# the trained ISO-12800 row KLD of every seed: twice the largest of the JAX
# package's own runs at this budget (0.0315, float64 seed 0; float32 reads
# 0.0014-0.0271 over seeds 0-2; tools/validate_proxy_seeded.py), as a few
# seeds do not bound the spread. The row head's log-scale walks onto its
# lower clamp in both packages; JAX's float32 key-0 run stays off it
# (PERF.md, section 6).
LADDER_ROW_12800_BAR = 0.063
CDF_FLOP = 30  # per Gaussian-CDF term of the pixel NLL: the CDF and its bin difference
BF16_EVAL_TOL = (1e-2, 1e-3)  # PSNR dB / SSIM: the bf16 eval limits (tests/test_torch_trainer.py)
PREDICT_CORNER = (1024, 1536)  # f32 predict, card against CPU: 6 tiles of 512^2
# the recipe A/B at full width (PNNP.yml's patch 512, batch 8, nf 32; the
# tool's d 256), its budget cut; held to tests/test_ab_recipe.py's bars
AB_ARGS = ["--patch", "512", "--batch", "8", "--nf", "32", "--d", "256",
           "--proxy-steps", "1000", "--unet-steps", "200", "--chunk", "100"]


def _structured(shape, seed):
    """Vertical gradient + per-channel scale + noise, on [0, 255]."""
    rng = np.random.default_rng(seed)
    H, W, C = shape
    grad = np.linspace(0, 200, H, dtype=np.float32)[:, None, None]
    chans = (np.arange(C, dtype=np.float32) + 1.0)[None, None, :] * 20.0
    x = np.clip(grad + chans + rng.uniform(0, 40, shape).astype(np.float32), 0, 255)
    y = np.clip(x + rng.normal(0, 12, shape).astype(np.float32), 0, 255)
    return x, y


def _bright(shape, seed):
    """200 + N(0, 0.5): large window sums, small variances."""
    rng = np.random.default_rng(seed)
    x = (200.0 + rng.normal(0, 0.5, shape)).astype(np.float32)
    y = (x + rng.normal(0, 0.5, shape)).astype(np.float32)
    return x, y


def _ssim_f64(x, y, data_range=255.0):
    """Mean SSIM of an [H, W, C] pair in float64 (uniform filter, valid crop)."""
    from scipy.ndimage import uniform_filter

    x, y = x.astype(np.float64), y.astype(np.float64)
    box = lambda a: uniform_filter(a, size=(7, 7, 1))[3:-3, 3:-3]
    ux, uy = box(x), box(y)
    cn = 49.0 / 48.0
    vx, vy = cn * (box(x * x) - ux * ux), cn * (box(y * y) - uy * uy)
    vxy = cn * (box(x * y) - ux * uy)
    c1, c2 = (0.01 * data_range) ** 2, (0.03 * data_range) ** 2
    return float(np.mean((2 * ux * uy + c1) * (2 * vxy + c2)
                         / ((ux * ux + uy * uy + c1) * (vx + vy + c2))))


def _routes(C):
    return ("hopper", "generic") if C == 4 else ("generic",)


def _check(cond, what):
    if not cond:
        raise AssertionError(what)


def _time_ms(fn, warmup, iters):
    """Median of per-call CUDA-event times (ms) after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _loop_ms(fn, warmup, iters):
    """Mean time (ms) of ``iters`` back-to-back calls between two CUDA
    events, after ``warmup`` calls: for kernels, whose launch overhead would
    otherwise dominate a per-call timing."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _profile(fn, step_ms, steps=3):
    """Device time by kernel, by class of kernel and by the op that launched
    it, over ``steps`` calls (torch.profiler), per call; and the device's
    idle share over the profiled window itself (CUDA events around it),
    beside the event-timed call time ``step_ms`` of an unprofiled run."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        start.record()
        for _ in range(steps):
            fn()
        end.record()
        torch.cuda.synchronize()
    window_ms = start.elapsed_time(end) / steps
    rows, ops, by_class = [], [], {}
    for e in prof.key_averages():
        if e.self_device_time_total <= 0:
            continue
        ms = e.self_device_time_total / steps / 1e3
        # A CPU op reports the device time of the kernels it launched: kept
        # apart from the kernels, so that busy time counts each kernel once.
        if e.device_type != DeviceType.CUDA:
            ops.append([e.key, ms])
            continue
        rows.append([e.key[:80], ms])
        cls = _kernel_class(e.key)
        by_class[cls] = by_class.get(cls, 0.0) + ms
    rows.sort(key=lambda r: -r[1])
    ops.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    return {"device_busy_ms": busy, "profiled_window_ms": window_ms,
            "idle_share": 1.0 - busy / window_ms, "step_ms": step_ms,
            "by_class_ms": by_class, "top_kernels_ms": rows[:12],
            "top_ops_ms": ops[:10]}


def _kernel_class(name):
    """Coarse class of a device kernel, by its name, for the step breakdown."""
    low = name.lower()
    if "ssim" in low:
        return "ssim kernel"
    if "nchwtonhwc" in low or "nhwctonchw" in low:
        return "cudnn layout transforms"
    if any(k in low for k in ("xmma", "cutlass", "cudnn", "conv", "gemm", "fft",
                              "grad_alg", "pointwise_mult_and_sum_complex")):
        return "cudnn convolution"
    if "poisson" in low:
        return "poisson sampler"
    if any(k in low for k in ("distribution", "philox", "normal_kernel", "uniform_kernel")):
        return "random draws"
    if "multi_tensor_apply" in low or "adam" in low:
        return "adam (foreach)"
    for key, cls in (("catarray", "concat"), ("max_pool", "max pool"),
                     ("reduce", "reductions"), ("elementwise", "elementwise")):
        if key in low:
            return cls
    return "other"


def _launcher(K, xf, yf, C, route):
    """One launch of an SSIM route on scratch allocated once: back to back,
    it times the kernel and not the wrapper's allocations."""
    H, L = xf.shape
    partials = torch.empty(K._library().pnnp_ssim_num_partials(H, L, C, K.ROUTES.index(route)),
                           dtype=torch.float64, device=xf.device)
    out = torch.empty((), dtype=torch.float64, device=xf.device)
    return lambda: K._launch(xf, yf, C, 255.0, route, partials, out)


def phase_build():
    from pnnp_tpu_torch.kernels import SOURCES, build_all

    t0 = time.perf_counter()
    build_all(SOURCES)
    print(f"build: {len(SOURCES)} CUDA source(s) in {time.perf_counter() - t0:.2f} s",
          flush=True)


def _to_dev(pair, dev):
    H, W, C = pair[0].shape
    return [torch.from_numpy(a.reshape(H, W * C)).to(dev) for a in pair]


def _unaligned(t):
    """A copy of a CUDA tensor whose data start 4 bytes off 16-byte alignment."""
    buf = torch.zeros(t.numel() + 1, dtype=t.dtype, device=t.device)
    buf[1:] = t.reshape(-1)
    return buf[1:].view(t.shape)


def _two_launches(K, xf, yf, C, route, what):
    """The SUM by ``route`` (None: the default), checked bit-identical over
    two launches."""
    a = K._ssim_call_sum(xf, yf, C, route=route)
    b = K._ssim_call_sum(xf, yf, C, route=route)
    torch.cuda.synchronize()
    _check(torch.equal(a, b), f"ssim {what}: two launches differ")
    return float(a)


def phase_kernel_checks(dev):
    """The generic route's grid against its Python mirror; each SSIM route
    against the plain version at every shape it takes. Returns the largest
    |kernel - plain| of the mean by route, and what the grid checks read."""
    import pnnp_tpu_torch.kernels.ssim as K

    # the generic grid: the kernel's partial count is the mirror's, over a
    # sweep of every C at strip and warp-column sizes and at the full frames
    lib = K._library()
    sweep = [(H, W, C) for C in range(1, K.MAX_C + 1) for H in (7, 23, 38, 1424, 2848)
             for W in (7, 61, 127, 2128, 4256)] + KERNEL_SHAPES + GENERIC_SHAPES + [DRIFT3]
    bad = [shape for shape in sweep if lib.pnnp_ssim_num_partials(
        shape[0], shape[1] * shape[2], shape[2], 0) != K.generic_grid(
        shape[0], shape[1] * shape[2], shape[2]).n_partials]
    _check(not bad, f"generic grid: the kernel's partial counts differ from the mirror's at {bad[:5]}")
    # the blocks per SM the runtime keeps resident cover each grid's plan,
    # so that every warp is resident in one wave
    occupancy = {str(C): {"runtime": K.resident_blocks_per_sm(C, "generic"),
                          "planned": K.generic_grid(64, 64 * C, C).blocks_per_sm}
                 for C in range(1, K.MAX_C + 1)}
    occupancy["hopper"] = {"runtime": K.resident_blocks_per_sm(4, "hopper"), "planned": 3}
    _check(all(o["runtime"] >= o["planned"] for o in occupancy.values()),
           f"SSIM blocks per SM below the grid's plan: {occupancy}")
    print(f"generic grid: {len(sweep)} frames match the mirror; blocks per SM {occupancy}",
          flush=True)

    max_err = dict.fromkeys(K.ROUTES, 0.0)
    for shape in KERNEL_SHAPES + GENERIC_SHAPES:
        H, W, C = shape
        xf, yf = _to_dev(_structured(shape, 0), dev)
        n = C * (H - 6) * (W - 6)
        ref = float(K.ssim_flat_plain(xf, yf, C))
        errs = {}
        for route in _routes(C):
            a = _two_launches(K, xf, yf, C, route, f"{route} {shape}")
            errs[route] = abs(a / n - ref)
            max_err[route] = max(max_err[route], errs[route])
            _check(errs[route] < TOL, f"ssim {route} {shape}: kernel {a / n} vs plain {ref}")
        if shape in (SONY, IMX686):
            gap = abs(float(K._ssim_call_sum(xf, yf, C, route="hopper"))
                      - float(K._ssim_call_sum(xf, yf, C, route="generic"))) / n
            _check(gap < 1e-5, f"ssim routes differ by {gap} at {shape}")
        # the entry points, on the default route
        a = K.ssim_flat(xf, yf, C)
        s = K.ssim_flat_sum(xf, yf, C)
        ref_sum = float(K.ssim_sum_plain(xf.reshape(H, W, C), yf.reshape(H, W, C)))
        _check(abs(float(a) - ref) < TOL, f"ssim_flat {shape}: {float(a)} vs plain {ref}")
        _check(abs(float(s) - ref_sum) < TOL * n,
               f"ssim_flat_sum {shape}: kernel {float(s)} vs plain {ref_sum}")
        if shape == (201, 140, 4):  # the banded and [H, W, C] entries
            band = lambda t: t.reshape(H, W, C).permute(2, 0, 1).reshape(C * H, W)
            _check(abs(float(K.ssim_banded(band(xf), band(yf), C)) - ref) < TOL,
                   "ssim_banded disagrees")
            _check(abs(float(K.ssim_kernel(xf.reshape(H, W, C),
                                           yf.reshape(H, W, C))) - ref) < TOL,
                   "ssim_kernel disagrees")
        print(f"kernel check ssim {shape}: |kernel - plain| = "
              + ", ".join(f"{r} {e:.3e}" for r, e in errs.items()), flush=True)

    # views 4 bytes off 16-byte alignment: the default route is generic (C = 4
    # too), on its 4-byte copies
    for C in (3, 4):
        H, W = UNALIGNED
        xu, yu = (_unaligned(t) for t in _to_dev(_structured((H, W, C), 5), dev))
        _check(K._route(H, W * C, C, xu.data_ptr(), yu.data_ptr()) == "generic",
               f"unaligned C={C} view not routed to generic")
        n = C * (H - 6) * (W - 6)
        err = abs(_two_launches(K, xu, yu, C, None, f"unaligned C={C}") / n
                  - float(K.ssim_flat_plain(xu, yu, C)))
        max_err["generic"] = max(max_err["generic"], err)
        _check(err < TOL, f"ssim generic unaligned C={C}: {err} from plain")
        print(f"kernel check ssim generic unaligned [{H}, {W}, {C}]: |kernel - plain| = "
              f"{err:.3e}", flush=True)

    for shape in (DRIFT, DRIFT3):
        x, y = _bright(shape, 0)
        H, W, C = shape
        xf, yf = _to_dev((x, y), dev)
        ref = _ssim_f64(x, y)
        n = C * (H - 6) * (W - 6)
        for route in _routes(C):
            err = abs(float(K._ssim_call_sum(xf, yf, C, route=route)) / n - ref)
            _check(err < TOL, f"ssim {route} drift frame {shape}: {err} from float64")
            print(f"kernel check ssim {route} bright frame {shape}: |kernel - float64| = "
                  f"{err:.3e}", flush=True)
    return max_err, {"generic_grid_frames": len(sweep), "blocks_per_sm": occupancy}


def _smoke_runfile(root):
    from pnnp_tpu_torch.config import load_runfile

    eld = load_runfile(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                    "runfiles", "SonyA7S2", "ELD.yml"))
    infos = os.path.join(root, "infos")
    dst = dict(eld["dst"], root_dir=root, infos_dir=infos, H=MOSAIC_H, W=MOSAIC_W)
    dst.pop("mode", None)
    # fewer than 41 scenes leave the default 250 split empty: sweep ratio 100
    dst_eval = dict(dst, dataset="SID_Dataset", dstname="SID", mode="eval",
                    ratio_list=[100])
    return {
        "mode": "eval",
        "checkpoint": os.path.join(root, "saved_model"),
        "fast_ckpt": os.path.join(root, "checkpoints"),
        "model_name": eld["model_name"],
        "result_dir": os.path.join(root, "images"),
        "num_workers": 2,
        "brightness_correct": True,
        "dst": dst,
        "dst_eval": dst_eval,
        "arch": dict(eld["arch"]),
        "hyper": dict(eld["hyper"]),
    }


def phase_main_path(dev):
    import yaml

    import pnnp_tpu_torch.kernels.ssim as K
    from pnnp_tpu_torch.data.fixtures import make_sid_fixture
    from pnnp_tpu_torch.models import UNetSeeInDark, params_to_jax
    from pnnp_tpu_torch.train.checkpoint import save_checkpoint
    from pnnp_tpu_torch.trainer import main as trainer_main

    cwd = os.getcwd()
    with tempfile.TemporaryDirectory(prefix="pnnp_smoke_") as root:
        t0 = time.perf_counter()
        make_sid_fixture(root, n_scenes=2, H=MOSAIC_H, W=MOSAIC_W)
        run = _smoke_runfile(root)
        nf = int(run["arch"]["nf"])
        seeded = UNetSeeInDark(nf=nf, generator=torch.Generator().manual_seed(0))
        ckpt = os.path.join(run["fast_ckpt"], f"{run['model_name']}_best_model.ckpt")
        save_checkpoint(ckpt, params_to_jax(seeded.state_dict()), meta={"epoch": 0})
        yml = os.path.join(root, "run.yml")
        with open(yml, "w") as f:
            yaml.safe_dump(run, f)
        print(f"main path: fixture + checkpoint in {time.perf_counter() - t0:.1f} s "
              f"(nf={nf}, {MOSAIC_H}x{MOSAIC_W})", flush=True)

        os.chdir(root)  # logs/ and metrics/ land in the temp dir
        try:
            torch.cuda.synchronize()
            K.launches = 0
            K.launches_by_route = dict.fromkeys(K.ROUTES, 0)
            t0 = time.perf_counter()
            trainer = trainer_main(["-f", yml, "--mode", "eval", "--nofig"])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = {"ssim": K.launches, "by_route": dict(K.launches_by_route)}
        finally:
            os.chdir(cwd)
        print(f"main path: --mode eval over 2 full frames in {wall:.2f} s, "
              f"launches {launches}", flush=True)

        with open(os.path.join(root, "metrics", f"{run['model_name']}_metrics.pkl"),
                  "rb") as f:
            metrics = pickle.load(f)
        _check(len(metrics) == 2, f"metrics pkl holds {len(metrics)} frames, not 2")
        _check(all(math.isfinite(v) for pair in metrics.values() for v in pair),
               f"non-finite metrics {metrics}")
        _check(launches["ssim"] >= 2, f"SSIM kernel launched {launches['ssim']} times")
        _check(launches["by_route"]["hopper"] == launches["ssim"]
               and launches["by_route"]["generic"] == 0,
               f"main-path SSIM launches by route {launches['by_route']}: not all hopper")
        _check(all(p.is_cuda for p in trainer.model.parameters()),
               "model parameters are not on the card")
        _check(trainer.model.conv1_1.weight.dtype == torch.bfloat16,
               "main path did not serve in bf16")

        # one frame again, its SSIM recomputed by the plain version on the card
        batch = trainer.dataset_eval[0]
        lr = torch.from_numpy(batch["lr"]).to(dev)
        hr = torch.from_numpy(batch["hr"]).to(dev)
        dnf, m = trainer._fused_eval(lr, hr, float(batch["ratio"][0]),
                                     ori=False, correct=True)
        H = hr.shape[1]
        plain = float(K.ssim_flat_plain(dnf[0] * 255.0,
                                        hr[0].clamp(0, 1).reshape(H, -1) * 255.0))
        err = max(abs(float(m["ssim"]) - plain),
                  abs(metrics[batch["name"]][1] - plain))
        _check(err < TOL, f"main-path frame SSIM {float(m['ssim'])} / "
                          f"{metrics[batch['name']][1]} vs plain {plain}")
        print(f"main path: metrics {metrics}; frame-0 SSIM |kernel - plain| = {err:.3e}",
              flush=True)
    return launches, err


def _train_runfile(root):
    run = _smoke_runfile(root)
    eld_train = dict(run["dst"], mode="train")
    # the 4 scenes sit in the SID 250 split (place_eval_split), the split an
    # eval leg of train() serves
    run["dst_eval"]["ratio_list"] = [250]
    run.update(mode="train", dst_train=eld_train, num_workers=4)
    run["hyper"].update(stop_epoch=TRAIN_EPOCHS, plot_freq=1, lr_scheduler="fixed",
                        learning_rate=TRAIN_LR, batch_size=1)
    return run


def phase_train_main_path(dev):
    """--mode train through the CLI entry; returns the SSIM launches of the
    run, what was checked, one host batch on the card and the loader's
    host time per batch."""
    import yaml

    import pnnp_tpu_torch.kernels.ssim as K
    import pnnp_tpu_torch.trainer as T
    from pnnp_tpu_torch.data import collate
    from pnnp_tpu_torch.data.fixtures import make_sid_fixture, place_eval_split
    from pnnp_tpu_torch.models import build_model, params_from_jax, params_to_jax
    from pnnp_tpu_torch.train import TrainStep, load_any

    cwd = os.getcwd()
    with tempfile.TemporaryDirectory(prefix="pnnp_train_") as root:
        t0 = time.perf_counter()
        infos = make_sid_fixture(root, n_scenes=TRAIN_SCENES, H=MOSAIC_H, W=MOSAIC_W)
        place_eval_split(root, infos, 250)
        run = _train_runfile(root)
        yml = os.path.join(root, "run.yml")
        with open(yml, "w") as f:
            yaml.safe_dump(run, f)
        print(f"train path: fixture in {time.perf_counter() - t0:.1f} s "
              f"({TRAIN_SCENES} scenes, {MOSAIC_H}x{MOSAIC_W})", flush=True)

        # observed, not configured: the loss and entry time of every step,
        # the frames each eval leg served, the trainer's log lines, and the
        # dtype of every convolution output computed with autograd on (the
        # train forwards; the eval legs run under no_grad)
        losses, step_at, legs, lines, conv_dtypes = [], [], [], [], set()
        call, evaluate, log = TrainStep.__call__, T.Trainer.eval, T.log

        def counted(self, model, opt, batch, gen, epoch):
            step_at.append((epoch, time.perf_counter()))
            m = call(self, model, opt, batch, gen, epoch)
            losses.append(float(m["loss"]))
            return m

        def eval_leg(self, epoch=-1):
            evaluate(self, epoch)
            legs.append((self.eval_psnr.count, epoch))

        def logged(string, *a, **k):
            lines.append(str(string))
            return log(string, *a, **k)

        def conv_hook(module, inputs, output):
            if torch.is_grad_enabled() and isinstance(
                    module, (torch.nn.Conv2d, torch.nn.ConvTranspose2d)):
                conv_dtypes.add(str(output.dtype).replace("torch.", ""))

        os.chdir(root)
        TrainStep.__call__, T.Trainer.eval, T.log = counted, eval_leg, logged
        hook = torch.nn.modules.module.register_module_forward_hook(conv_hook)
        try:
            torch.cuda.synchronize()
            K.launches = 0
            K.launches_by_route = dict.fromkeys(K.ROUTES, 0)
            t0 = time.perf_counter()
            trainer = T.main(["-f", yml, "--mode", "train", "--nofig"])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = {"ssim": K.launches, "by_route": dict(K.launches_by_route)}
        finally:
            hook.remove()
            TrainStep.__call__, T.Trainer.eval, T.log = call, evaluate, log
            os.chdir(cwd)
        out = "\n".join(lines)

        steps = TRAIN_SCENES * TRAIN_EPOCHS
        _check("aborted by RuntimeError" not in out, "an epoch was aborted")
        _check(len(losses) == steps and all(math.isfinite(x) for x in losses),
               f"train steps: {len(losses)} of {steps}, losses {losses}")
        epochs = re.findall(r"^Epoch (\d+): loss ok, train_psnr=(\S+), lr=(\S+), "
                            r"time=\S+s \[loader \d+% net \d+%\]$", out, re.M)
        _check([int(e) for e, _, _ in epochs] == list(range(1, TRAIN_EPOCHS + 1))
               and all(math.isfinite(float(p)) and float(lr) > 0 for _, p, lr in epochs),
               f"epoch lines {epochs}")
        _check(conv_dtypes == {"bfloat16"}, f"train convolutions ran in {conv_dtypes}")
        _check(all(p.is_cuda and p.dtype == torch.float32
                   for p in trainer.model.parameters()), "master params not f32 on the card")
        want = [(TRAIN_SCENES, e) for e in range(1, TRAIN_EPOCHS + 1)] + [(TRAIN_SCENES, -1)]
        _check(legs == want, f"eval legs (frames, epoch) {legs}, want {want}")
        e1 = out[out.index("Epoch 1: loss ok"):out.index("Epoch 2: loss ok")]
        _check("Best PSNR is" in e1 and "Period boundary: reloaded best checkpoint" in e1,
               "best not written at epoch 1 or not reloaded at the period boundary")
        frames = sum(n for n, _ in legs)
        _check(launches["ssim"] == frames == launches["by_route"]["hopper"],
               f"SSIM launches {launches} for {frames} eval frames")
        with open(os.path.join(root, "metrics", f"{run['model_name']}_metrics.pkl"),
                  "rb") as f:
            metrics = pickle.load(f)
        _check(len(metrics) == TRAIN_SCENES
               and all(math.isfinite(v) for pair in metrics.values() for v in pair),
               f"metrics pkl {metrics}")

        init = build_model(run["arch"], dtype=torch.float32,
                           generator=torch.Generator().manual_seed(trainer.seed))
        init = params_to_jax(init.state_dict())
        moved = {}
        for name in ("last", "best"):
            ckpt = load_any(os.path.join(run["fast_ckpt"],
                                         f"{run['model_name']}_{name}_model.ckpt"))
            net = build_model(run["arch"], dtype=torch.float32)
            net.load_state_dict(params_from_jax(ckpt["params"]), strict=True)
            moved[name] = max(float(np.abs(ckpt["params"][n][k] - init[n][k]).max())
                              for n in init for k in init[n])
            _check(moved[name] > 0.1 * TRAIN_LR, f"{name} params did not move: {moved}")
        print(f"train path: --mode train, {steps} steps + {frames} eval frames in "
              f"{wall:.2f} s; losses {[round(x, 5) for x in losses]}; eval legs {legs}; "
              f"launches {launches}; params moved by up to {moved}", flush=True)

        # wall ms from one step's entry to the next inside an epoch: the
        # step, its one sync and the wait for the next batch
        step_wall = [1e3 * (b - a) for (e, a), (f, b) in zip(step_at, step_at[1:]) if e == f]

        # the host loader: one thread, one full frame -> 8 crops of 512^2 per
        # batch; then at the runfile's worker count, alone and feeding the step
        ds = trainer.dataset_train
        loader_ms = []
        for i in range(TRAIN_SCENES + 1):
            t0 = time.perf_counter()
            host = collate([ds[i % len(ds)]])
            loader_ms.append(1e3 * (time.perf_counter() - t0))
        pace = _loader_pace(trainer)
        loader_split = _loader_split(ds)
        batch = trainer._train_batch(host)
        del trainer
    result = {"wall_s": wall, "steps": steps, "losses": losses, "eval_legs": legs,
              "params_moved": moved, "conv_dtypes": sorted(conv_dtypes),
              "launches": launches, "epoch_lines": [e for e in lines if ": loss ok," in e],
              "step_wall_ms": step_wall,
              "loader_ms_per_batch": {"one_thread": {
                  "first": loader_ms[0], "median_rest": statistics.median(loader_ms[1:]),
                  "all": loader_ms, "split_ms": loader_split}, **pace}}
    return launches, result, batch


class _Cycle:
    """``n`` items cycling over a data set: one long epoch for the loader
    loops."""

    def __init__(self, ds, n):
        self.ds, self.n = ds, n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return self.ds[i % len(self.ds)]

    def reseed_worker(self, *args):
        self.ds.reseed_worker(*args)


def _loader_pace(trainer, n=None, dataset=None, warmup=4):
    """The trainer's DataLoader at its runfile's worker count over ``n``
    items (default: 8 passes of the train set) of ``dataset`` (default: the
    train set) in one epoch: host ms between batches when nothing consumes
    them, and wall ms per step when they feed the trainer's own step as
    ``train()`` does (to the device, the step, one sync). Both after
    ``warmup`` batches, whose prefetch the workers fill at once."""
    from pnnp_tpu_torch.data import DataLoader

    workers = int(trainer.args.get("num_workers", 2))
    gen = torch.Generator(device=trainer.device).manual_seed(0)
    dataset = dataset or trainer.dataset_train
    n = n or 8 * len(dataset)

    def step(host):
        m = trainer.train_step(trainer.model, trainer.opt, trainer._train_batch(host), gen, 1)
        float(m["psnr"])

    out = {"workers": workers}
    for name, consume in (("alone", lambda host: None), ("feeding_step", step)):
        loader = DataLoader(_Cycle(dataset, n), batch_size=1,
                            num_workers=workers, seed=trainer.seed)
        stamps = []
        for host in loader:
            consume(host)
            stamps.append(time.perf_counter())
        gaps = [1e3 * (b - a) for a, b in zip(stamps[warmup:], stamps[warmup + 1:])]
        out[name] = {"median_ms": statistics.median(gaps), "mean_ms": statistics.mean(gaps),
                     "n": len(gaps)}
    print(f"host loader, {type(dataset).__name__}, {workers} workers: {out}", flush=True)
    return out


def _loader_split(ds, frames=TRAIN_SCENES):
    """Median host ms of each stage of one train example (one thread): npy
    read, native pack to [1424, 2128, 4], the 8 crops (with flips / rot90)."""
    from pnnp_tpu_torch.data.io import dataload

    parts = {"read": [], "pack": [], "crop": []}
    for i in range(frames):
        t0 = time.perf_counter()
        raw = np.asarray(dataload(ds.infos[i]["long"])).reshape(ds.H, ds.W)
        t1 = time.perf_counter()
        packed = ds.pack(raw, clip=True)
        t2 = time.perf_counter()
        ds.make_planner().crop(packed)
        t3 = time.perf_counter()
        for k, a, b in zip(parts, (t0, t1, t2), (t1, t2, t3)):
            parts[k].append(1e3 * (b - a))
    return {k: statistics.median(v) for k, v in parts.items()}


def phase_train_step_check(dev):
    """One f32 step at nf=4 on 8x32^2: the same weights and batch on the card
    and on the CPU. Loss within 1e-5 relative, each gradient within 1e-4 of
    its largest magnitude. Then the bf16 step's gradients on the card
    against the card's f32 ones: each within 5e-2 of its largest magnitude
    (bf16 rounding reads 1.4e-2 on the CPU here; a zero gradient reads 1)."""
    from pnnp_tpu_torch.models import UNetSeeInDark
    from pnnp_tpu_torch.train import identity_synth, make_train_step

    rng = np.random.default_rng(0)
    hr = rng.uniform(0, 0.5, (CROPS, 4, 32, 32)).astype(np.float32)
    lr = (hr + rng.normal(0, 0.05, hr.shape)).astype(np.float32)
    res = {}
    for d, bf16 in ((dev, False), (torch.device("cpu"), False), (dev, True)):
        step = make_train_step(lambda e: TRAIN_LR, identity_synth, clip_mode=2, bf16=bf16)
        net = UNetSeeInDark(nf=4, generator=torch.Generator().manual_seed(1)).to(d)
        loss, _ = step.forward_backward(net, torch.from_numpy(lr).to(d),
                                        torch.from_numpy(hr).to(d))
        res[d.type, bf16] = (float(loss), {n: p.grad.cpu() for n, p in net.named_parameters()})
    (lc, gc), (lh, gh), (l16, g16) = res["cuda", False], res["cpu", False], res["cuda", True]
    rel = lambda a, b: max(float((a[n] - g).abs().max() / g.abs().max()) for n, g in b.items())
    loss_rel, grad_rel, bf16_rel = abs(lc - lh) / abs(lh), rel(gc, gh), rel(g16, gc)
    _check(loss_rel <= 1e-5, f"f32 step loss card {lc} vs cpu {lh}")
    _check(grad_rel <= 1e-4, f"f32 step gradients differ by {grad_rel} of their max")
    _check(abs(l16 - lc) < 2e-3, f"bf16 step loss {l16} vs f32 {lc}")
    _check(bf16_rel < 5e-2, f"bf16 step gradients differ by {bf16_rel} of their max")
    print(f"train step check: f32 nf=4 8x32^2 card vs cpu: loss rel {loss_rel:.2e}, "
          f"grad rel {grad_rel:.2e}; bf16 vs f32 on the card: loss {abs(l16 - lc):.2e}, "
          f"grad rel {bf16_rel:.2e}", flush=True)
    return {"loss_rel": loss_rel, "grad_rel_of_max": grad_rel,
            "bf16_loss_abs": abs(l16 - lc), "bf16_grad_rel_of_max": bf16_rel}


def _unet_flops_per_pixel(nf, in_nc=4, out_nc=4):
    """Forward multiply-adds x 2 of UNetSeeInDark per full-resolution pixel:
    two 3x3 convs per level (level k at 1/4^k of the pixels), a 2x2
    stride-2 transposed conv and two 3x3 convs per decoder level, a 1x1
    head."""
    conv = lambda ci, co, k=3: 2 * k * k * ci * co
    chans = [nf * 2**k for k in range(5)]
    enc = conv(in_nc, nf) + conv(nf, nf) + sum(
        (conv(chans[k - 1], chans[k]) + conv(chans[k], chans[k])) / 4**k for k in range(1, 5))
    dec = sum((2 * chans[k + 1] * chans[k] + conv(2 * chans[k], chans[k])
               + conv(chans[k], chans[k])) / 4**k for k in range(4))
    return enc + dec + conv(nf, out_nc, 1)


def _split_ms(step, model, opt, batch, gen, warmup=3, iters=10):
    """Median CUDA-event time of each stage of the step: synth (+ clip),
    forward + loss + backward, and the Adam update."""
    parts = {"synth": [], "forward_backward": [], "adam": []}
    for i in range(warmup + iters):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        ev[0].record()
        lr_img, hr_img = step.make_pair(batch, gen)
        ev[1].record()
        step.forward_backward(model, lr_img, hr_img)
        ev[2].record()
        step.update(opt, 1)
        ev[3].record()
        torch.cuda.synchronize()
        if i >= warmup:
            for k, a, b in zip(parts, ev, ev[1:]):
                parts[k].append(a.elapsed_time(b))
    return {k: statistics.median(v) for k, v in parts.items()}


def phase_train_timings(dev, batch):
    """The train step at 8x512^2 pgrq, nf=32, on the main path's own batch."""
    from pnnp_tpu_torch.models import UNetSeeInDark
    from pnnp_tpu_torch.train import make_adam, make_raw_synth, make_train_step

    step_ms, split, profiles, bound = {}, {}, {}, {}
    n, _, h, w = batch["hr"].shape
    flops = 3 * _unet_flops_per_pixel(32) * n * h * w  # forward + backward (2x forward)
    for name, bf16 in (("bfloat16", True), ("float32", False)):
        net = UNetSeeInDark(nf=32, generator=torch.Generator().manual_seed(0)).to(dev)
        opt = make_adam(net.parameters())
        step = make_train_step(lambda e: TRAIN_LR,
                               make_raw_synth("SonyA7S2", "pgrq", ori=False, clip=True),
                               clip_mode=True, bf16=bf16)
        gen = torch.Generator(device=dev).manual_seed(0)
        call = lambda: step(net, opt, batch, gen, 1)
        step_ms[name] = _time_ms(call, warmup=3, iters=10)
        split[name] = _split_ms(step, net, opt, batch, gen)
        profiles[name] = _profile(call, step_ms[name])
        bound[name] = flops / (BF16_FLOP_PER_S if bf16 else FP32_FLOP_PER_S) * 1e3
        print(f"train step {name}: {step_ms[name]:.3f} ms (split {split[name]}, "
              f"bound {bound[name]:.3f} ms)", flush=True)
        del net, opt, step, call
        torch.cuda.empty_cache()
    return {"batch": list(batch["hr"].shape), "noise_code": "pgrq", "nf": 32,
            "train_step_ms": step_ms, "train_step_split_ms": split,
            "synth_share": {k: split[k]["synth"] / step_ms[k] for k in step_ms},
            "train_flops_per_step": flops, "train_bound_ms": bound,
            "train_bound_share": {k: bound[k] / step_ms[k] for k in step_ms},
            "train_step_profile": profiles}


def phase_timings(dev):
    import pnnp_tpu_torch.kernels.ssim as K
    from pnnp_tpu_torch.models import UNetSeeInDark
    from pnnp_tpu_torch.train.steps import make_eval_metrics_step

    h, w = MOSAIC_H // 2, MOSAIC_W // 2
    rng = np.random.default_rng(1)
    lr = torch.from_numpy(rng.uniform(0, 0.4, (1, h, w * 4)).astype(np.float32)).to(dev)
    hr = torch.from_numpy(rng.uniform(0, 1, (1, h, w * 4)).astype(np.float32)).to(dev)
    mpix = h * w * 4 / 1e6
    step_ms, profiles = {}, {}
    # bf16 first: the f32 step turns TF32 off for the rest of the process
    for dtype in (torch.bfloat16, torch.float32):
        net = UNetSeeInDark(nf=32, dtype=dtype,
                            generator=torch.Generator().manual_seed(0)).to(dev).eval()
        step = make_eval_metrics_step(net)
        call = lambda: step(lr, hr, 1.0, correct=True)
        name = str(dtype).replace("torch.", "")
        step_ms[name] = _time_ms(call, warmup=3, iters=10)
        profiles[name] = _profile(call, step_ms[name])
        del net, step, call
    torch.cuda.empty_cache()

    # each route at every frame it serves, in turns (hopper, generic,
    # generic, hopper where both take it), against its bound, and the plain
    # version: both routes at the raw Sony and IMX686 frames (generic
    # forced), generic at rgb_quality's sRGB frames (C = 3). The kernels are
    # timed on scratch allocated once (see _launcher).
    kernel_us, bounds, plain_ms = {}, {}, {}
    frames = {"sony": SONY, "imx686": IMX686, "sony_srgb": SRGB_SONY,
              "imx686_srgb": SRGB_IMX686}
    for frame, shape in frames.items():
        H, W, C = shape
        xf, yf = _to_dev(_structured(shape, 2), dev)
        routes = _routes(C)
        runs = {r: [] for r in routes}
        for route in routes + routes[::-1]:
            runs[route].append(1e3 * _loop_ms(_launcher(K, xf, yf, C, route),
                                              warmup=5, iters=100))
        kernel_us[frame] = {r: statistics.mean(v) for r, v in runs.items()}
        kernel_us[frame]["runs"] = runs
        # the same through the allocating wrapper, host overhead included
        kernel_us[frame]["wrapper"] = {r: 1e3 * _loop_ms(
            lambda: K._ssim_call_sum(xf, yf, C, route=r), warmup=5, iters=100)
            for r in routes}
        bytes_moved = 2 * xf.numel() * 4 + 8
        ops = (H - 6) * (W - 6) * C * SSIM_OPS_PER_WINDOW + xf.numel() * 3
        t_bytes, t_ops = bytes_moved / HBM_BYTES_PER_S * 1e3, ops / FP32_FLOP_PER_S * 1e3
        bounds[frame] = {"bound_ms": max(t_bytes, t_ops), "bytes": bytes_moved, "ops": ops,
                         "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
        plain_ms[frame] = _loop_ms(lambda: K.ssim_flat_plain(xf, yf, C), warmup=2, iters=10)
        print(f"ssim at {frame} {list(shape)}: us by route {kernel_us[frame]} "
              f"(bound {bounds[frame]['bound_ms'] * 1e3:.1f} us)", flush=True)
        del xf, yf
    torch.cuda.empty_cache()
    # each route's time, bound and share at every frame it was timed at; its
    # row at the Sony frame of its path: hopper at the raw frame of the eval
    # step, generic at the sRGB frame of rgb_quality
    by_shape = {route: {frame: {
        "shape": [shape[0], shape[1] * shape[2]], "C": shape[2],
        "ms": kernel_us[frame][route] / 1e3, "plain_ms": plain_ms[frame],
        "bound_ms": bounds[frame]["bound_ms"], "bound_by": bounds[frame]["bound_by"],
        "bound_share": bounds[frame]["bound_ms"] / (kernel_us[frame][route] / 1e3),
    } for frame, shape in frames.items() if route in kernel_us[frame]} for route in K.ROUTES}
    row_frame = {"hopper": "sony", "generic": "sony_srgb"}
    rows = {route: {
        "shape": list(frames[row_frame[route]]),
        **{k: by_shape[route][row_frame[route]][k]
           for k in ("ms", "plain_ms", "bound_ms", "bound_by", "bound_share")},
        # no single PyTorch call computes SSIM
        "library_ms": None,
        "by_shape": by_shape[route],
    } for route in K.ROUTES}
    timings = {
        "frame": [1, h, w, 4], "mpix_per_frame": mpix,
        "eval_step_ms": step_ms,
        "eval_mpix_s": {k: mpix / (v / 1e3) for k, v in step_ms.items()},
        "ssim_us_by_route": kernel_us, "ssim_bounds": bounds, "ssim_plain_ms": plain_ms,
        "eval_step_profile": profiles,
    }
    return rows, timings


# ------------------------------------------------------------------ proxy
def _pnnp_yml():
    from pnnp_tpu_torch.config import load_runfile

    return load_runfile(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                     "runfiles", "SonyA7S2", "PNNP.yml"))


def _fresh_proxy(dev, d=None):
    """PNNP.yml's arch_proxy (at width ``d``, default PROXY_D) at flax's init
    law (seed 0), on ``dev``."""
    from pnnp_tpu_torch.models import build_proxy

    arch = dict(_pnnp_yml()["arch_proxy"], d=d or PROXY_D)
    return build_proxy(arch, generator=torch.Generator().manual_seed(0)).to(dev)


def proxy_quantile_check(dev):
    """quantile and quantile_dot at d=1024 on the card against the CPU, on
    the same heads, u and c: the core within 1e-6 of the knot span, draws
    with the Laplace tail within 1e-6 of the largest |draw| (log1p)."""
    from pnnp_tpu_torch.models import QuantileHead

    proxy = _fresh_proxy("cpu")
    with torch.no_grad():
        _, hp, _ = proxy.heads(torch.tensor([800.0, 3200.0, 12800.0]), 3)
    rng = np.random.default_rng(0)
    u = torch.from_numpy(rng.uniform(1e-6, 1 - 1e-6, (3, 4, 64, 64)).astype(np.float32))
    c = torch.from_numpy(rng.uniform(0, 1, u.shape).astype(np.float32))
    span = float((hp.knots[:, -1] - hp.knots[:, 0]).min())
    hp_dev = type(hp)(*[t.to(dev) for t in hp])
    errs = {}
    for name in ("quantile", "quantile_dot"):
        fn = getattr(QuantileHead, name)
        for tail in (False, True):
            cpu = fn(hp, u, c if tail else None)
            card = fn(hp_dev, u.to(dev), c.to(dev) if tail else None).cpu()
            scale = float(cpu.abs().max()) if tail else span
            errs[f"{name}{'_tail' if tail else ''}"] = err = float((card - cpu).abs().max()) / scale
            _check(err <= 1e-6, f"{name} (tail {tail}) card vs cpu: {err:.2e} of {scale}")
    return errs


def _dark_noise(seed, shape):
    """Dark-noise-like residual, normalized: 3 ADU pixels + 1 ADU rows."""
    rng = np.random.default_rng(seed)
    n, c, h, w = shape
    x = rng.normal(0, 3, shape) + rng.normal(0, 1, (n, c, h, 1))
    return torch.from_numpy((x / 15871.0).astype(np.float32))


def proxy_loss_check(dev):
    """The proxy loss (nll, nll_px, nll_row) and its gradients at d=1024 on
    the card against the CPU: 1e-5 relative, 1e-4 of each gradient's max."""
    noise = _dark_noise(1, (2, 4, 64, 64))
    iso = torch.tensor([800.0, 6400.0])
    res = {}
    for d in ("cpu", dev):
        proxy = _fresh_proxy(d)
        nll, aux = proxy.loss(noise.to(d), iso.to(d))
        nll.backward()
        res[str(d)] = ({"nll": nll.item(), **{k: v.item() for k, v in aux.items()}},
                       {n: p.grad.cpu() for n, p in proxy.named_parameters()})
    (lc, gc), (lh, gh) = res[str(dev)], res["cpu"]
    loss_rel = max(abs(lc[k] - lh[k]) / abs(lh[k]) for k in lh)
    grad_rel = max(float((gc[n] - g).abs().max() / g.abs().max()) for n, g in gh.items())
    _check(loss_rel <= 1e-5, f"proxy loss card {lc} vs cpu {lh}")
    _check(grad_rel <= 1e-4, f"proxy gradients card vs cpu: {grad_rel:.2e} of their max")
    return {"loss_rel": loss_rel, "grad_rel_of_max": grad_rel, "loss": lh}


def proxy_sample_check(dev):
    """At the recipe shape (8 x 4 x 512 x 512, one ISO): the sample's
    variance within 2% of the closed form (pixel + s0^2 + row + mean shot
    K*clean_adu, over span^2), its mean within 3 standard errors of 0
    (zero_mean; the row draws are shared along a row)."""
    from pnnp_tpu_torch.models import QuantileHead

    proxy = _fresh_proxy(dev)
    n, iso = CROPS, 3200.0
    gen = torch.Generator(device=dev).manual_seed(0)
    clean = torch.rand((n, 4, PATCH, PATCH), generator=gen, device=dev) * 0.02
    span = proxy.wp - proxy.bl
    with torch.no_grad():
        noise = proxy.sample(clean, torch.tensor([iso], device=dev), gen)
        feat, hp_px, hp_row = proxy.heads(torch.tensor([iso], device=dev), 1)
        var_row = float(QuantileHead.variance(hp_row)) / span ** 2
        var_px = (float(QuantileHead.variance(hp_px)) + proxy.smooth_s0 ** 2) / span ** 2
        var_shot = float(feat[0, 0] * clean.mean() * span) / span ** 2
        mean, var = float(noise.mean()), float(noise.var())
    closed = var_px + var_row + var_shot
    rows = n * 4 * PATCH
    se = math.sqrt((var_px + var_shot) / noise.numel() + var_row / rows)
    _check(torch.isfinite(noise).all() and noise.shape == clean.shape, "sample not finite")
    _check(abs(var / closed - 1.0) <= 0.02, f"sample variance {var} vs closed form {closed}")
    _check(abs(mean) <= 3 * se, f"sample mean {mean} vs standard error {se}")
    return {"var_ratio": var / closed, "mean_in_se": mean / se, "shape": list(noise.shape)}


def phase_proxy_checks(dev):
    out = {"quantile_rel": proxy_quantile_check(dev), "loss": proxy_loss_check(dev),
           "sample": proxy_sample_check(dev)}
    print(f"proxy checks (card vs cpu, d={PROXY_D}): {out}", flush=True)
    return out


def phase_iso_ladder(dev, save):
    """tools/validate_proxy.py on the card at the JAX ladder test's budget,
    once per seed of LADDER_SEEDS (tools/ladder_spread.py), the last run's
    params saved to ``save`` (JAX layout, for ``phase_proxy_tools``): every
    run's NLL finite, its trained ISOs inside the test's bars and its
    trained-12800 row KLD at most LADDER_ROW_12800_BAR. The held-out ISO
    6400 is reported against its bar, not held to it: how the conditioning
    MLP interpolates between the trained ISOs at this budget depends on the
    init draw (PERF.md, section 6), and the JAX test's bar was set on one draw,
    its key 0."""
    from pnnp_tpu_torch.tools.ladder_spread import main as spread

    t0 = time.perf_counter()
    res = spread(["--seeds", LADDER_SEEDS] + LADDER_ARGS + ["--save", save], device=dev)
    _check(os.path.exists(save), f"the ladder saved no params at {save}")
    wall = time.perf_counter() - t0
    for run in res["runs"]:
        rows = run["rows"]
        _check(math.isfinite(run["nll"]), f"ladder seed {run['seed']} nll {run['nll']}")
        _check([r["iso"] for r in rows] == [800, 1600, 3200, 12800, 6400]
               and all(math.isfinite(r["kld"]) and math.isfinite(r["row_kld"]) for r in rows),
               f"ladder seed {run['seed']} rows {rows}")
        _check(all(r["inside"] for r in rows if not r["heldout"]),
               f"ladder seed {run['seed']}: a trained ISO over the test's bars: {rows}")
        row_12800 = next(r["row_kld"] for r in rows if r["iso"] == 12800)
        _check(row_12800 <= LADDER_ROW_12800_BAR,
               f"ladder seed {run['seed']}: trained-12800 row KLD {row_12800} over "
               f"{LADDER_ROW_12800_BAR}")
    law_12800 = [(r["row_kld"], r["row_law_std"], r["row_law_support"])
                 for run in res["runs"] for r in run["rows"] if r["iso"] == 12800]
    held = res["spread"][6400]
    print(f"iso ladder: {LADDER_ARGS}, seeds {LADDER_SEEDS}, in {wall:.1f} s; trained ISOs "
          f"inside the test's bars and 12800 row KLD <= {LADDER_ROW_12800_BAR} in every run "
          f"(row KLD, row law std, support: {law_12800}); held-out 6400 inside its bar in "
          f"{held['inside']} of {len(res['runs'])} runs (KLD {held['kld_min']}-"
          f"{held['kld_max']}, row {held['row_kld_min']}-{held['row_kld_max']})", flush=True)
    return dict(res, wall_s=wall)


def _pnnp_dst(root):
    """PNNP.yml's dst block on the smoke's SID fixture. The fixture has no
    dark-shading resources: the paired loaders run without the command."""
    dst = dict(_pnnp_yml()["dst"], root_dir=root, infos_dir=os.path.join(root, "infos"),
               H=MOSAIC_H, W=MOSAIC_W, patch_size=PATCH, crop_per_image=CROPS)
    dst.pop("mode", None)
    return dst


def _nf_runfile(root):
    """The proxy's NLL trainer: PNNP.yml's arch_proxy at full width on the
    fixture's SID pairs, one 512^2 crop per step, 2 epochs."""
    pnnp, dst = _pnnp_yml(), _pnnp_dst(root)
    return {
        "mode": "train", "model_name": "SonyA7S2_PNNP_proxy", "num_workers": 2,
        "checkpoint": os.path.join(root, "saved_model"),
        "fast_ckpt": os.path.join(root, "checkpoints"),
        "dst": dst, "dst_train": dict(dst, dataset="SID_Dataset", mode="train",
                                      command="idremap", crop_per_image=1),
        "arch": dict(pnnp["arch"]), "arch_proxy": dict(pnnp["arch_proxy"], d=PROXY_D),
        "hyper": {"lr_scheduler": "fixed", "learning_rate": NF_LR, "batch_size": 1,
                  "last_epoch": 0, "stop_epoch": TRAIN_EPOCHS, "plot_freq": 1,
                  "save_freq": 1},
    }


def _pnnp_runfile(root, proxy_ckpt):
    """PNNP.yml's --mode train: its arch, arch_proxy and Proxy_Dataset, with
    the proxy trainer's checkpoint; 8 crops of 512^2, 2 epochs at a fixed lr,
    an eval leg per epoch over the SID 250 split, then evaltest."""
    pnnp, dst = _pnnp_yml(), _pnnp_dst(root)
    _check(pnnp["dst_train"]["dataset"] == "Proxy_Dataset", "PNNP.yml trains on Proxy_Dataset")
    return {
        "mode": "train", "model_name": pnnp["model_name"], "num_workers": 4,
        "brightness_correct": True, "proxy_checkpoint": proxy_ckpt,
        "checkpoint": os.path.join(root, "saved_model"),
        "fast_ckpt": os.path.join(root, "checkpoints"),
        "result_dir": os.path.join(root, "images"),
        "dst": dst,
        "dst_train": dict(_pnnp_dst(root), **{k: pnnp["dst_train"][k] for k in
                                              ("dataset", "mode", "command")}),
        "dst_eval": dict(dst, dataset="SID_Dataset", mode="eval", command="",
                         ratio_list=[250]),
        "arch": dict(pnnp["arch"]), "arch_proxy": dict(pnnp["arch_proxy"], d=PROXY_D),
        "hyper": dict(pnnp["hyper"], stop_epoch=TRAIN_EPOCHS, plot_freq=1,
                      lr_scheduler="fixed", learning_rate=PNNP_LR, batch_size=1),
    }


def phase_pnnp_paths(dev):
    """The paper's method end to end on one 4-scene 2848x4256 fixture:
    ``trainer_nf.main --kind proxy`` (PNNP.yml's proxy at d=1024), then
    ``trainer.main --mode train`` of PNNP.yml driven by its checkpoint.
    Returns (SSIM launches of the PNNP run, what was checked)."""
    import yaml

    import pnnp_tpu_torch.kernels.ssim as K
    import pnnp_tpu_torch.trainer as T
    import pnnp_tpu_torch.trainer_nf as NF
    from pnnp_tpu_torch.data.fixtures import make_sid_fixture, place_eval_split
    from pnnp_tpu_torch.models import PixelWiseISOProxy, params_to_jax
    from pnnp_tpu_torch.train import TrainStep, load_any

    cwd = os.getcwd()
    out = {}
    with tempfile.TemporaryDirectory(prefix="pnnp_proxy_") as root:
        infos = make_sid_fixture(root, n_scenes=TRAIN_SCENES, H=MOSAIC_H, W=MOSAIC_W)
        place_eval_split(root, infos, 250)
        lines, log_t, log_nf = [], T.log, NF.log
        logged = lambda base: (lambda s, *a, **k: (lines.append(str(s)), base(s, *a, **k)))
        steps, make_step = [], NF.make_proxy_train_step

        def timed_step(*a, **k):
            step = make_step(*a, **k)

            def run(*b):
                start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                start.record()
                m = step(*b)
                end.record()
                steps.append((start, end, float(m["nll"])))
                return m
            return run

        os.chdir(root)
        T.log, NF.log = logged(log_t), logged(log_nf)
        try:
            # --- the proxy's NLL trainer ------------------------------------
            yml = os.path.join(root, "nf.yml")
            with open(yml, "w") as f:
                yaml.safe_dump(_nf_runfile(root), f)
            NF.make_proxy_train_step = timed_step
            try:
                _proxy_core_zero()
                torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                nf = NF.main(["-f", yml, "--kind", "proxy"])
                torch.cuda.synchronize()
                nf_wall = time.perf_counter() - t0
                peak = torch.cuda.max_memory_allocated()
                nf_core = _proxy_core_read()
            finally:
                NF.make_proxy_train_step = make_step
            text = "\n".join(lines)
            nll_lines = re.findall(r"Epoch (\d+): nll/dim=(\S+) \(", text)
            kld_lines = re.findall(r"Epoch (\d+): KLD fwd=(\S+) inv=(\S+) sym=(\S+)", text)
            ckpt = nf.ckpt.last_path()
            _check([int(e) for e, _ in nll_lines] == list(range(1, TRAIN_EPOCHS + 1))
                   and all(math.isfinite(float(v)) for _, v in nll_lines),
                   f"proxy trainer epoch lines {nll_lines}")
            _check(len(kld_lines) == TRAIN_EPOCHS
                   and all(math.isfinite(float(x)) for k in kld_lines for x in k[1:]),
                   f"proxy trainer KLD lines {kld_lines}")
            _check(os.path.exists(ckpt) and load_any(ckpt)["meta"]["epoch"] == TRAIN_EPOCHS,
                   f"proxy checkpoint {ckpt}")
            _check(nf.model.d == PROXY_D
                   and all(p.device.type == dev.type for p in nf.model.parameters()),
                   "proxy trainer not at d=1024 on the card")
            step_ms = [a.elapsed_time(b) for a, b, _ in steps]
            _check(len(steps) == TRAIN_SCENES * TRAIN_EPOCHS
                   and all(math.isfinite(x) for *_, x in steps), f"proxy steps {steps}")
            # each step: one forward and one backward of each head
            _check(nf_core["bwd"] == 2 * len(steps) and nf_core["fwd"] >= 2 * len(steps),
                   f"proxy trainer: proxy core launches {nf_core} for {len(steps)} steps")
            out["proxy_trainer"] = {
                "proxy_core_launches": nf_core,
                "wall_s": nf_wall, "steps": len(steps), "nll": [x for *_, x in steps],
                "step_ms": step_ms, "step_ms_median": statistics.median(step_ms),
                "peak_mem_gib": peak / 2**30, "epoch_lines": nll_lines,
                "kld_lines": kld_lines, "checkpoint": os.path.basename(ckpt)}
            print(f"proxy trainer: {out['proxy_trainer']}", flush=True)
            del nf
            torch.cuda.empty_cache()

            # --- PNNP.yml --mode train with the proxy synth -----------------
            run = _pnnp_runfile(root, ckpt)
            yml = os.path.join(root, "pnnp.yml")
            with open(yml, "w") as f:
                yaml.safe_dump(run, f)
            losses, legs, samples = [], [], []
            call, evaluate, sample = TrainStep.__call__, T.Trainer.eval, PixelWiseISOProxy.sample

            def counted(self, model, opt, batch, gen, epoch):
                m = call(self, model, opt, batch, gen, epoch)
                losses.append(float(m["loss"]))
                return m

            def eval_leg(self, epoch=-1):
                evaluate(self, epoch)
                legs.append((self.eval_psnr.count, epoch))

            def sampled(self, clean, iso, generator):
                samples.append((tuple(clean.shape), clean.device.type))
                return sample(self, clean, iso, generator)

            TrainStep.__call__, T.Trainer.eval, PixelWiseISOProxy.sample = (
                counted, eval_leg, sampled)
            del lines[:]
            try:
                torch.cuda.synchronize()
                K.launches = 0
                K.launches_by_route = dict.fromkeys(K.ROUTES, 0)
                _proxy_core_zero()
                t0 = time.perf_counter()
                trainer = T.main(["-f", yml, "--mode", "train", "--nofig"])
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                launches = {"ssim": K.launches, "by_route": dict(K.launches_by_route)}
                pnnp_core = _proxy_core_read()  # the synth samples: no NLL
            finally:
                TrainStep.__call__, T.Trainer.eval, PixelWiseISOProxy.sample = (
                    call, evaluate, sample)
        finally:
            T.log, NF.log = log_t, log_nf
            os.chdir(cwd)
        text = "\n".join(lines)
        steps_n = TRAIN_SCENES * TRAIN_EPOCHS
        _check("aborted by RuntimeError" not in text, "a PNNP epoch was aborted")
        _check(f"Loaded proxy checkpoint {ckpt}" in text, "proxy checkpoint not loaded")
        _check(len(losses) == steps_n and all(math.isfinite(x) for x in losses),
               f"PNNP steps {len(losses)} of {steps_n}, losses {losses}")
        _check(samples == [((CROPS, 4, PATCH, PATCH), dev.type)] * steps_n,
               f"proxy samples {samples}: the proxy was not the synth of every step")
        want = [(TRAIN_SCENES, e) for e in range(1, TRAIN_EPOCHS + 1)] + [(TRAIN_SCENES, -1)]
        _check(legs == want, f"PNNP eval legs (frames, epoch) {legs}, want {want}")
        frames = sum(n for n, _ in legs)
        _check(launches["ssim"] == frames == launches["by_route"]["hopper"],
               f"PNNP SSIM launches {launches} for {frames} eval frames")
        _check(trainer.proxy is not None and trainer.proxy.d == PROXY_D
               and all(p.device.type == dev.type and not p.requires_grad
                       for p in trainer.proxy.parameters()),
               "the PNNP proxy is not the frozen d=1024 proxy on the card")
        _check(int(trainer.arch["nf"]) == 32, "PNNP denoiser not at nf=32")
        init = T.build_model(run["arch"], dtype=torch.float32,
                             generator=torch.Generator().manual_seed(trainer.seed))
        init = params_to_jax(init.state_dict())
        last = load_any(os.path.join(run["fast_ckpt"], f"{run['model_name']}_last_model.ckpt"))
        moved = max(float(np.abs(last["params"][n][k] - init[n][k]).max())
                    for n in init for k in init[n])
        _check(moved > 0.1 * PNNP_LR, f"PNNP params did not move: {moved}")
        _check(not any(pnnp_core.values()), f"PNNP --mode train ran the NLL: {pnnp_core}")
        out["pnnp_main_path"] = {
            "proxy_core_launches": pnnp_core, "wall_s": wall, "steps": steps_n, "losses": losses, "eval_legs": legs,
            "proxy_samples": len(samples), "launches": launches, "params_moved": moved,
            "epoch_lines": [e for e in lines if ": loss ok," in e]}
        print(f"PNNP path: --mode train (Proxy_Dataset, nf=32, proxy d={PROXY_D}), "
              f"{steps_n} steps + {frames} eval frames in {wall:.2f} s; losses "
              f"{[round(x, 5) for x in losses]}; launches {launches}; "
              f"params moved by up to {moved}", flush=True)
        ckpt_params = load_any(ckpt)["params"]
    return launches, out, ckpt_params


def _nll_step_ms(dev, proxy, n, h, w, iso=3200.0):
    """Median CUDA-event time of one proxy NLL step (loss, backward, Adam)
    on pgrq dark frames [n, 4, h, w], and the step's peak memory."""
    from pnnp_tpu_torch.physics import calibration as calib
    from pnnp_tpu_torch.physics.noise import generate_noisy
    from pnnp_tpu_torch.train import make_adam
    from pnnp_tpu_torch.trainer_nf import make_proxy_train_step

    t = calib.ISO_TABLES["SonyA7S2"]
    i = calib.iso_index("SonyA7S2", iso)
    full = lambda v: torch.full((n,), float(v), device=dev)
    params = dict(K=full(t["Kmax"][i]), sigTL=full(t["sigTL"][i]), sigR=full(t["sigR"][i]),
                  sigGs=full(t["sigGs"][i]), lam=full(t["lam"][i]), q=full(t["q"]),
                  bias=torch.zeros((n, 4), device=dev), ratio=full(1.0), wp=full(t["wp"]),
                  bl=full(t["bl"]))
    gen = torch.Generator(device=dev).manual_seed(0)
    noise = generate_noisy(gen, torch.zeros((n, 4, h, w), device=dev), params, "pgrq",
                           ori=True)
    hr, ratio, isos = torch.zeros_like(noise), full(1.0), full(iso)
    step = make_proxy_train_step(proxy, lambda e: 5e-4)
    opt = make_adam(proxy.parameters())
    call = lambda: step(opt, noise, hr, ratio, isos, 1)
    ms = _time_ms(call, warmup=3, iters=10)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    call()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    d = proxy.d
    cdfs = n * 4 * h * w * (d + 1) + n * 4 * h * (d + 1)  # pixel + row terms, forward
    bound = cdfs * CDF_FLOP / FP32_FLOP_PER_S * 1e3
    return {"shape": [n, 4, h, w], "d": d, "ms": ms, "peak_mem_gib": peak / 2**30,
            "cdf_terms": cdfs, "fwd_flop_bound_ms": bound, "bound_share": bound / ms}, call


def phase_proxy_timings(dev, batch, proxy_params):
    """The proxy synth beside the physics synth at the main path's batch
    (8 x 512^2), the bf16 train step with the proxy synth, and the proxy
    NLL step at patch 512 (d=1024) and at the ladder's shape (d=256)."""
    from pnnp_tpu_torch.models import UNetSeeInDark, params_from_jax
    from pnnp_tpu_torch.train import make_adam, make_proxy_synth, make_raw_synth, make_train_step

    proxy = _fresh_proxy(dev)
    proxy.load_state_dict(params_from_jax(proxy_params), strict=True)
    proxy.requires_grad_(False)
    synths = {
        "proxy": make_proxy_synth(lambda g, clean, iso: proxy.sample(clean, iso, g)),
        "physics": make_raw_synth("SonyA7S2", "pgrq", ori=False, clip=True),
    }
    synth_ms = {}
    for name in ("proxy", "physics", "physics", "proxy"):  # in turns
        step = make_train_step(lambda e: PNNP_LR, synths[name], clip_mode=2, bf16=True)
        gen = torch.Generator(device=dev).manual_seed(0)
        synth_ms.setdefault(name, []).append(
            _time_ms(lambda: step.make_pair(batch, gen), warmup=3, iters=10))
    net = UNetSeeInDark(nf=32, generator=torch.Generator().manual_seed(0)).to(dev)
    opt = make_adam(net.parameters())
    step = make_train_step(lambda e: PNNP_LR, synths["proxy"], clip_mode=2, bf16=True)
    gen = torch.Generator(device=dev).manual_seed(0)
    call = lambda: step(net, opt, batch, gen, 1)
    train_ms = _time_ms(call, warmup=3, iters=10)
    split = _split_ms(step, net, opt, batch, gen)
    torch.cuda.reset_peak_memory_stats()
    call()
    torch.cuda.synchronize()
    train_peak = torch.cuda.max_memory_allocated()
    del net, opt, step, call
    torch.cuda.empty_cache()

    nll = {}
    for name, d, shape in (("patch512", PROXY_D, (1, PATCH, PATCH)),
                           ("ladder", 256, (8, 32, 32))):
        nll[name], call = _nll_step_ms(dev, _fresh_proxy(dev, d), *shape)
        if name == "patch512":
            nll[name]["profile"] = _profile(call, nll[name]["ms"], steps=2)
        print(f"proxy NLL step {name}: {nll[name]['ms']:.3f} ms, peak "
              f"{nll[name]['peak_mem_gib']:.2f} GiB (forward FLOP bound "
              f"{nll[name]['fwd_flop_bound_ms']:.3f} ms)", flush=True)
        torch.cuda.empty_cache()
    out = {"synth_ms": {k: statistics.mean(v) for k, v in synth_ms.items()},
           "synth_ms_runs": synth_ms, "train_step_proxy_bf16_ms": train_ms,
           "train_step_proxy_split_ms": split, "train_step_proxy_peak_gib": train_peak / 2**30,
           "nll_step": nll}
    print(f"proxy synth {out['synth_ms']} ms; bf16 train step with the proxy synth "
          f"{train_ms:.3f} ms (split {split}, peak {train_peak / 2**30:.2f} GiB)", flush=True)
    return out


# ------------------------------------------------- the proxy NLL's kernels
PROXY_CORE_ISOS = (800.0, 12800.0)
# core, knot gradient: of their largest float64 magnitude, and at most twice
# the plain f32 path's error plus 1e-6 (tests/test_torch_cuda_proxy_kernel.py)
PROXY_CORE_TOL = (1e-5, 5e-4)
SFU_PER_S = 16 * 132 * 1.98e9  # erfc, exp: 16 a clock per SM, 132 SMs, 1.98 GHz
PROXY_OPS_PER_KNOT, PROXY_OPS_PER_BIN = 4, 27  # portbench/counts.py's count of _core_conv


def _proxy_core_zero():
    """Set the proxy core kernels' launch counts to 0 (the work before done)."""
    import pnnp_tpu_torch.kernels.proxy_core as PC

    torch.cuda.synchronize()
    PC.launches = 0
    PC.launches_by_kernel = dict.fromkeys(PC.KERNELS, 0)


def _proxy_core_read():
    import pnnp_tpu_torch.kernels.proxy_core as PC

    torch.cuda.synchronize()
    return dict(PC.launches_by_kernel)


def _core_plain(knots, x, s, g, dtype, chunk=8192):
    """``_core_conv`` and the knots' gradient of sum(core * g) in ``dtype``,
    ``chunk`` values at a time."""
    from pnnp_tpu_torch.models import QuantileHead

    kn = knots.to(dtype).detach().requires_grad_(True)
    xd, gd = x.to(dtype), g.to(dtype)
    sd = torch.broadcast_to(s, x.shape).to(dtype)
    cores = []
    for a in range(0, x.shape[1], chunk):
        c = QuantileHead._core_conv(kn[:, None, :], xd[:, a:a + chunk, None],
                                    sd[:, a:a + chunk, None])
        (c * gd[:, a:a + chunk]).sum().backward()
        cores.append(c.detach())
    return torch.cat(cores, 1), kn.grad


def _plain_path(knots, x, s, grad):
    """The plain path as ``log_prob_conv_gaussian`` runs it: chunks of
    ``CONV_CHUNK_ELEMS``, checkpointed under autograd."""
    from torch.utils.checkpoint import checkpoint

    from pnnp_tpu_torch.models.proxy import CONV_CHUNK_ELEMS, QuantileHead

    n, m = x.shape
    chunk = max(1, CONV_CHUNK_ELEMS // (n * knots.shape[1]))
    s = torch.broadcast_to(s, x.shape)
    parts = []
    for a in range(0, m, chunk):
        args = (knots[:, None, :], x[:, a:a + chunk, None], s[:, a:a + chunk, None])
        parts.append(checkpoint(QuantileHead._core_conv, *args, use_reentrant=False,
                                preserve_rng_state=False) if grad
                     else QuantileHead._core_conv(*args))
    core = torch.cat(parts, 1)
    if grad:
        core.sum().backward()


def _proxy_core_head(knots, x, s, g):
    """One head's checks and times (see :func:`phase_proxy_core`)."""
    import pnnp_tpu_torch.kernels.proxy_core as PC
    from pnnp_tpu_torch.utils import profiling

    n, m = x.shape
    d = knots.shape[1] - 1
    kn = knots.clone().requires_grad_(True)
    core = PC.core_conv(kn, x, s)
    (core * g).sum().backward()
    ref_core, ref_grad = _core_plain(knots, x, s, g, torch.float64)
    f32_core, f32_grad = _core_plain(knots, x, s, g, torch.float32)
    err = lambda a, ref: float((a.double() - ref).abs().max() / ref.abs().max())
    e = {"core": err(core, ref_core), "knot_grad": err(kn.grad, ref_grad),
         "core_plain_f32": err(f32_core, ref_core), "knot_grad_plain_f32": err(f32_grad, ref_grad)}
    for k, tol in zip(("core", "knot_grad"), PROXY_CORE_TOL):
        _check(e[k] <= tol and e[k] <= 2 * e[f"{k}_plain_f32"] + 1e-6,
               f"proxy core {k} at {[n, m]}, d={d}: {e}")
    kn2 = knots.clone().requires_grad_(True)
    core2 = PC.core_conv(kn2, x, s)
    (core2 * g).sum().backward()
    _check(torch.equal(core, core2) and torch.equal(kn.grad, kn2.grad),
           f"proxy core at {[n, m]}: two launches differ")
    del ref_core, ref_grad, f32_core, f32_grad, core, core2
    order = PC.order_of(x, s)
    walked = {}
    for kernel, fn in (("fwd", lambda: PC._forward(knots, x, s, order)),
                       ("bwd", lambda: PC._backward(knots, x, s, g, order))):
        profiling.reset()
        with profiling.enable():
            fn()
        torch.cuda.synchronize()
        c = profiling.snapshot()["counters"]
        walked[kernel] = c["proxy.core_pairs_walked"] / c["proxy.core_pairs"]
    profiling.reset()
    fwd = _loop_ms(lambda: PC._forward(knots, x, s), warmup=2, iters=20)
    sort = _loop_ms(lambda: PC.order_of(x, s), warmup=2, iters=20)
    bwd = _loop_ms(lambda: PC._backward(knots, x, s, g, order), warmup=2, iters=20)
    path = _loop_ms(lambda: PC.core_conv(kn, x, s).backward(g), warmup=2, iters=20)
    with torch.no_grad():
        plain_fwd = _loop_ms(lambda: _plain_path(knots, x, s, False), warmup=1, iters=1)
    plain = _loop_ms(lambda: _plain_path(kn, x, s, True), warmup=1, iters=1)
    ops = n * m * (PROXY_OPS_PER_KNOT * (d + 1) + PROXY_OPS_PER_BIN * d)
    sfu = n * m * (2 * d + 1)
    t_ops, t_sfu = ops / FP32_FLOP_PER_S * 1e3, sfu / SFU_PER_S * 1e3
    bound = 3 * max(t_ops, t_sfu)  # the backward twice the forward
    torch.cuda.empty_cache()
    bound_walked = bound / 3 * (walked["fwd"] + 2 * walked["bwd"])
    return {"shape": [n, m], "d": d, "s_per_value": int(s.shape[1] != 1),
            "ms": fwd + bwd, "fwd_ms": fwd, "bwd_ms": bwd, "sort_ms": sort,
            "walked_share": walked, "bound_walked_ms": bound_walked,
            "bound_share_walked": bound_walked / (fwd + bwd), "path_fwd_bwd_ms": path,
            "plain_ms": plain, "plain_fwd_ms": plain_fwd,
            "bound_ms": bound, "bound_fwd_ms": bound / 3, "ops": ops, "erfc_exp": sfu,
            "bound_by": "operations" if t_ops >= t_sfu else "erfc and exp",
            "bound_share": bound / (fwd + bwd), "fwd_bound_share": bound / 3 / fwd,
            "bwd_bound_share": 2 * bound / 3 / bwd, "err_of_max": e}


def phase_proxy_core(dev):
    """The proxy NLL's kernel pair (``kernels/proxy_core.py``,
    ``csrc/proxy_core.cu``) at the main path's shape. PNNP.yml's proxy (d =
    1024, seed 0) gives each head's knots at each of ``PROXY_CORE_ISOS``;
    the pixel head scores one [1, 4, 512, 512] frame (1,048,576 values, x ~
    N(0, the law's sd), s = s0), the row head its 2,048 row means (one s a
    value). For each: the core and the knots' gradient of sum(core * g)
    against float64 ``_core_conv`` within ``PROXY_CORE_TOL``; two launches
    bit-identical; the forward and the backward kernel alone (mean of 20
    back-to-back launches; the forward with its sort, ``sort_ms`` the sort
    alone), the whole path with autograd, and the plain chunked path once
    after a warm-up call; the bound of that input: the larger of 31 float32
    operations a (value, knot) pair at ``FP32_FLOP_PER_S`` and 2d + 1 erfc
    and exp calls a value at ``SFU_PER_S``, the backward twice the forward,
    over the full grid and (``bound_walked_ms``) over the share of pairs
    each kernel walked (``walked_share``).
    Returns (the ``kernels`` row's fields, the largest errors)."""
    from pnnp_tpu_torch.models import QuantileHead

    proxy = _fresh_proxy(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    m = 4 * PATCH * PATCH
    by_shape = {}
    for iso in PROXY_CORE_ISOS:
        with torch.no_grad():
            _, hp_px, hp_row = proxy.heads(torch.tensor([iso], device=dev), 1)
            sd = float(QuantileHead.variance(hp_px)) ** 0.5
        x = torch.randn(1, m, generator=gen, device=dev) * sd
        g = torch.rand(1, m, generator=gen, device=dev) - 0.3
        by_shape[f"pixel_iso{int(iso)}"] = _proxy_core_head(
            hp_px.knots.detach().contiguous(), x,
            torch.full((1, 1), proxy.smooth_s0, device=dev), g)
        r = 4 * PATCH
        xr = torch.randn(1, r, generator=gen, device=dev) * sd / PATCH ** 0.5
        sr = (0.5 + torch.rand(1, r, generator=gen, device=dev)) * sd / PATCH ** 0.5
        gr = torch.rand(1, r, generator=gen, device=dev) - 0.3
        by_shape[f"row_iso{int(iso)}"] = _proxy_core_head(
            hp_row.knots.detach().contiguous(), xr, sr, gr)
        for head in ("pixel", "row"):
            h = by_shape[f"{head}_iso{int(iso)}"]
            print(f"proxy core {head} head, ISO {int(iso)}, {h['shape']} d={h['d']}: fwd "
                  f"{h['fwd_ms']:.3f} ms (sort {h['sort_ms']:.3f}), bwd {h['bwd_ms']:.3f} ms "
                  f"(bound {h['bound_fwd_ms']:.3f} / {2 * h['bound_fwd_ms']:.3f}, "
                  f"{h['bound_share']:.1%} of it; walked {h['walked_share']}, bound "
                  f"{h['bound_walked_ms']:.3f}, {h['bound_share_walked']:.1%} of it), path "
                  f"{h['path_fwd_bwd_ms']:.3f} ms, plain {h['plain_fwd_ms']:.2f} / "
                  f"{h['plain_ms']:.2f} ms; errors of the max {h['err_of_max']}", flush=True)
    errs = {k: max(h["err_of_max"][k] for h in by_shape.values()) for k in ("core", "knot_grad")}
    main = by_shape[f"pixel_iso{int(PROXY_CORE_ISOS[0])}"]
    row = {"shape": [1, 4, PATCH, PATCH], "d": PROXY_D,
           **{k: main[k] for k in ("ms", "fwd_ms", "bwd_ms", "sort_ms", "plain_ms", "bound_ms",
                                   "bound_by", "bound_share", "walked_share",
                                   "bound_walked_ms", "bound_share_walked")},
           # no PyTorch call computes the Gaussian-convolved bin law
           "library_ms": None, "by_shape": by_shape}
    return row, errs


# ------------------------------------------------ IMX686 and the baselines
LRID_H, LRID_W = 3472, 4624  # IMX686 full frame, packed [1736, 2312, 4]
LRID_CROPS = 12  # the IMX686 runfiles' crop_per_image
LRID_ENTRIES, LRID_FRAMES = 59, 2  # info entries (split tables name ids <= 58), frames on disk
LRID_DGAINS = (1.0, 2.0, 4.0, 8.0, 16.0)
BASELINE_EPOCHS = 1  # the IMX686 recipes: one epoch of their 'small' quarter


def _recipe(rel):
    from pnnp_tpu_torch.config import load_runfile

    return load_runfile(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                     "runfiles", rel + ".yml"))


def _recipe_runfile(rel, root, fixture, *, epochs, extra_command="", **dst_kw):
    """A runfile of ``runfiles/<rel>.yml`` at its full width on a fixture:
    its datasets, commands, noise code, arch (nf=32), arch_proxy (d=1024),
    crops and batch size kept; paths pointed at the fixture (no dark-shading
    resources: ``ds_dir`` unset), ``epochs`` epochs at the recipe's lr held
    fixed, an eval leg every epoch, and ``extra_command`` appended to the
    train set's command."""
    rec = _recipe(rel)
    paths = dict(root_dir=fixture, infos_dir=os.path.join(fixture, "infos"),
                 bias_dir=os.path.join(fixture, "bias"), ds_dir=None, **dst_kw)
    run = {k: (dict(rec[k], **paths) if isinstance(rec.get(k), dict) else rec.get(k))
           for k in ("dst", "dst_train", "dst_eval", "dst_test")}
    if extra_command:
        run["dst_train"]["command"] += ", " + extra_command
    run.update({
        "mode": "train", "model_name": rec["model_name"], "num_workers": rec["num_workers"],
        "brightness_correct": rec["brightness_correct"],
        "checkpoint": os.path.join(root, "saved_model"),
        "fast_ckpt": os.path.join(root, "checkpoints"),
        "result_dir": os.path.join(root, "images"),
        "arch": dict(rec["arch"]),
        "hyper": dict(rec["hyper"], stop_epoch=epochs, plot_freq=1, lr_scheduler="fixed"),
    })
    if rec.get("arch_proxy"):
        run["arch_proxy"] = dict(rec["arch_proxy"])
    return run


class _Observed:
    """What a run did, read by wrapping the port's own functions: the loss of
    every step, the frames of every eval leg, the trainer's log lines, the
    shape of every SSIM call, the illuminance corrections, the SNA calls,
    and per batch the synth's ratio and ISO and whether it pasted a bias
    frame."""

    def __init__(self):
        self.losses, self.legs, self.lines, self.ssim_shapes = [], [], [], []
        self.corrections = self.sna_calls = 0
        self.batches = []  # (unique ratios, unique ISOs, pasted crops) per synth call
        self.hbr_devices, self.hbr_map = set(), None
        self.keep = None  # one device batch with a paste, for checks after the run

    def __enter__(self):
        import pnnp_tpu_torch.train.steps as S
        import pnnp_tpu_torch.trainer as T
        from pnnp_tpu_torch.train import TrainStep

        self._saved = [(TrainStep, "__call__"), (T.Trainer, "eval"), (T, "log"),
                       (S, "ssim_flat"), (S, "illuminance_correct"), (S, "sna"),
                       (T, "make_proxy_synth"), (T, "make_mix_synth")]
        self._orig = [getattr(o, a) for o, a in self._saved]
        call, evaluate, log, ssim, correct, sna, proxy_f, mix_f = self._orig
        obs = self

        def counted(step, model, opt, batch, gen, epoch):
            m = call(step, model, opt, batch, gen, epoch)
            obs.losses.append(float(m["loss"]))
            return m

        def eval_leg(trainer, epoch=-1):
            evaluate(trainer, epoch)
            obs.legs.append((trainer.eval_psnr.count, epoch))

        def logged(string, *a, **k):
            obs.lines.append(str(string))
            return log(string, *a, **k)

        def ssim_rec(x, y, *a, **k):
            obs.ssim_shapes.append(tuple(x.shape))
            return ssim(x, y, *a, **k)

        def correct_rec(*a, **k):
            obs.corrections += 1
            return correct(*a, **k)

        def sna_rec(*a, **k):
            obs.sna_calls += 1
            return sna(*a, **k)

        def watch(synth):
            def run(generator, batch):
                lr, hr, ratio = synth(generator, batch)
                iso = batch.get("iso")
                black = batch.get("black_lr")
                pasted = 0 if black is None else int((black > 0).sum())
                obs.batches.append((sorted(set(ratio.tolist())),
                                    None if iso is None else sorted(set(iso.tolist())),
                                    pasted))
                if pasted and obs.keep is None:
                    obs.keep = {k: v.clone() for k, v in batch.items()}
                return lr, hr, ratio
            return run

        def proxy_rec(*a, **k):
            return watch(proxy_f(*a, **k))

        def mix_rec(*a, hbr_map=None, **k):
            if hbr_map is not None:
                inner = hbr_map

                def hbr_map(g, x):
                    obs.hbr_devices.add(x.device.type)
                    return inner(g, x)
                obs.hbr_map = hbr_map
            return watch(mix_f(*a, hbr_map=hbr_map, **k))

        for (o, a), f in zip(self._saved, (counted, eval_leg, logged, ssim_rec, correct_rec,
                                           sna_rec, proxy_rec, mix_rec)):
            setattr(o, a, f)
        return self

    def __exit__(self, *exc):
        for (o, a), f in zip(self._saved, self._orig):
            setattr(o, a, f)


def _run_recipe(run, root, mode):
    """``trainer.main`` of a recipe runfile, observed; returns the trainer,
    what it did, its wall time and the SSIM launches of the run."""
    import yaml

    import pnnp_tpu_torch.kernels.ssim as K
    import pnnp_tpu_torch.trainer as T

    yml = os.path.join(root, f"{run['model_name']}.yml")
    with open(yml, "w") as f:
        yaml.safe_dump(run, f)
    cwd = os.getcwd()
    os.chdir(root)
    try:
        with _Observed() as obs:
            torch.cuda.synchronize()
            K.launches = 0
            K.launches_by_route = dict.fromkeys(K.ROUTES, 0)
            t0 = time.perf_counter()
            trainer = T.main(["-f", yml, "--mode", mode, "--nofig"])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = {"ssim": K.launches, "by_route": dict(K.launches_by_route)}
    finally:
        os.chdir(cwd)
    text = "\n".join(obs.lines)
    _check("aborted by RuntimeError" not in text, f"{run['model_name']}: an epoch was aborted")
    steps = len(trainer.dataset_train) * int(run["hyper"]["stop_epoch"])
    _check(len(obs.losses) == steps and all(math.isfinite(x) for x in obs.losses),
           f"{run['model_name']}: {len(obs.losses)} of {steps} steps, losses {obs.losses}")
    frames = sum(n for n, _ in obs.legs)
    _check(launches["ssim"] == frames == launches["by_route"]["hopper"],
           f"{run['model_name']}: SSIM launches {launches} for {frames} eval frames")
    return trainer, obs, wall, launches


def _params_moved(trainer, run, lr):
    from pnnp_tpu_torch.models import build_model, params_to_jax
    from pnnp_tpu_torch.train import load_any

    init = params_to_jax(build_model(run["arch"], dtype=torch.float32,
                                     generator=torch.Generator().manual_seed(trainer.seed))
                         .state_dict())
    last = load_any(os.path.join(run["fast_ckpt"], f"{run['model_name']}_last_model.ckpt"))
    moved = max(float(np.abs(last["params"][n][k] - init[n][k]).max())
                for n in init for k in init[n])
    _check(moved > 0.1 * lr, f"{run['model_name']}: params did not move ({moved})")
    return moved


def _summary(run, obs, wall, launches, moved):
    return {"wall_s": wall, "steps": len(obs.losses), "losses": obs.losses,
            "eval_legs": obs.legs, "launches": launches, "params_moved": moved,
            "synth_batches": len(obs.batches),
            "pasted_batches": sum(1 for *_, p in obs.batches if p),
            "epoch_lines": [e for e in obs.lines if ": loss ok," in e]}


def _hbr_card_check(dev, hbr, shape):
    """The IMX686 HBR map on the card against the CPU on one uniform field
    and one quantized bias batch at the recipe's shape: within 1e-6
    (normalized)."""
    import pnnp_tpu_torch.physics.hbr as HB

    span = 1023.0 - 64.0
    g = torch.Generator().manual_seed(0)
    sig = float(hbr.lut[6400]["scale"])
    data = (torch.randn(shape, generator=g) * sig).round() / span
    field = torch.rand(shape, generator=g)
    draw = HB._uniform
    try:
        outs = []
        for d in (dev, torch.device("cpu")):
            HB._uniform = lambda gen, sh, device: field.to(device)
            outs.append(hbr.map(torch.Generator(device=d), data.to(d), iso=6400).cpu())
    finally:
        HB._uniform = draw
    err = float((outs[0] - outs[1]).abs().max())
    _check(err <= 1e-6, f"HBR card vs cpu: {err}")
    return err


def phase_baselines(dev, base):
    """The IMX686 camera and the paper's baselines at full width:
    ``runfiles/IMX686/PNNP.yml --mode train`` and ``IMX686/PMN.yml --mode
    trainonly`` on a 3472x4624 LRID fixture (12 crops of 512^2, their
    ``small`` quarter, one epoch at the recipe's lr), then
    ``SonyA7S2/PMN.yml --mode train`` and ``SonyA7S2/SFRN.yml --mode
    trainonly`` on a 2848x4256 SID fixture with an ISO-1600 bias library,
    all under the directory ``base``. Returns (SSIM launches by run, what was
    checked, device batches and trainers for the timings)."""
    from pnnp_tpu_torch.data.fixtures import make_lrid_fixture, make_sid_fixture, place_eval_split
    from pnnp_tpu_torch.models import PixelWiseISOProxy

    out, launches, keep = {}, {}, {}
    lrid, sid = os.path.join(base, "lrid"), os.path.join(base, "sid")
    t0 = time.perf_counter()
    make_lrid_fixture(lrid, n_scenes=LRID_ENTRIES, H=LRID_H, W=LRID_W, n_frames=LRID_FRAMES,
                      shorts_per_dgain=1, n_bias=2)
    infos = make_sid_fixture(sid, n_scenes=TRAIN_SCENES, H=MOSAIC_H, W=MOSAIC_W,
                             bias_isos=(1600,), n_bias=2)
    place_eval_split(sid, infos, 250)
    print(f"baselines: fixtures in {time.perf_counter() - t0:.1f} s (LRID {LRID_ENTRIES} "
          f"entries on {LRID_FRAMES} frames, {LRID_H}x{LRID_W}; SID {TRAIN_SCENES} scenes "
          f"+ ISO-1600 bias)", flush=True)

    # --- IMX686 PNNP: the proxy at its seed-0 init (no proxy_checkpoint) --
    root = tempfile.mkdtemp(prefix="pnnp_imx686_pnnp_", dir=lrid)
    run = _recipe_runfile("IMX686/PNNP", root, lrid, epochs=BASELINE_EPOCHS,
                          extra_command="small")
    samples, sample = [], PixelWiseISOProxy.sample

    def sampled(self, clean, iso, generator):
        samples.append((tuple(clean.shape), clean.device.type))
        return sample(self, clean, iso, generator)

    PixelWiseISOProxy.sample = sampled
    try:
        tr, obs, wall, launches["imx686_pnnp"] = _run_recipe(run, root, "train")
    finally:
        PixelWiseISOProxy.sample = sample
    n = len(obs.losses)
    _check(samples == [((LRID_CROPS, 4, PATCH, PATCH), dev.type)] * n,
           f"IMX686 PNNP proxy samples {samples[:3]}...: not the synth of every step")
    _check(len(obs.batches) == n and all(len(r) == 1 and r[0] in LRID_DGAINS and i == [6400.0]
                                         for r, i, _ in obs.batches),
           f"IMX686 PNNP: dgain / ISO per batch {obs.batches}")
    _check(tr.proxy.d == PROXY_D and int(tr.arch["nf"]) == 32, "IMX686 PNNP not at full width")
    _check(obs.corrections == 0, f"{obs.corrections} IMX686 evals were illuminance-corrected")
    _check(set(obs.ssim_shapes) == {(IMX686[0], IMX686[1] * 4)},
           f"IMX686 SSIM shapes {set(obs.ssim_shapes)}")
    want = [(3, 1)] + [(9, -1)] * 10  # fast-eval scenes; 9 eval scenes x 5 dgains, twice
    _check(obs.legs == want, f"IMX686 PNNP eval legs {obs.legs}, want {want}")
    moved = _params_moved(tr, run, run["hyper"]["learning_rate"])
    out["imx686_pnnp"] = dict(_summary(run, obs, wall, launches["imx686_pnnp"], moved),
                              dgains=sorted({r[0] for r, _, _ in obs.batches}),
                              corrections=obs.corrections, ssim_shape=list(obs.ssim_shapes[0]))
    print(f"IMX686 PNNP: --mode train, {n} steps + {sum(k for k, _ in obs.legs)} eval frames "
          f"in {wall:.2f} s; dgains {out['imx686_pnnp']['dgains']}; launches "
          f"{launches['imx686_pnnp']}; params moved by up to {moved}", flush=True)
    del tr
    torch.cuda.empty_cache()

    # --- IMX686 PMN: bias pastes, HBR on the card, SNA ---------------------
    root = tempfile.mkdtemp(prefix="pnnp_imx686_pmn_", dir=lrid)
    run = _recipe_runfile("IMX686/PMN", root, lrid, epochs=BASELINE_EPOCHS,
                          extra_command="small")
    tr, obs, wall, launches["imx686_pmn"] = _run_recipe(run, root, "trainonly")
    n = len(obs.losses)
    pasted = sum(1 for *_, p in obs.batches if p)
    _check(pasted >= 1, f"IMX686 PMN: no batch pasted a bias frame in {n}")
    _check(obs.sna_calls == n, f"IMX686 PMN: SNA ran {obs.sna_calls} times in {n} steps")
    _check(obs.hbr_devices == {dev.type}, f"IMX686 PMN: HBR ran on {obs.hbr_devices}")
    # HBR touches the pasted crops only: without WB deltas ('noaug') SNA adds
    # nothing to the paired crops, so they leave the synth bit for bit, while
    # the pasted ones differ from the same synth without HBR
    from pnnp_tpu_torch.train.steps import make_mix_synth

    b = obs.keep
    mask = b["black_lr"] > 0
    outs = [make_mix_synth("IMX686", "noaug", ori=False, hbr_map=m, host_amplified=True)(
        torch.Generator(device=dev).manual_seed(0), b)[0] for m in (obs.hbr_map, None)]
    _check(torch.equal(outs[0][~mask], b["lr"][~mask]),
           "IMX686 PMN: the HBR synth changed a paired crop")
    _check(bool((outs[0][mask] != outs[1][mask]).any()), "IMX686 PMN: HBR left the pastes alone")
    from pnnp_tpu_torch.physics.hbr import HighBitRecovery

    hbr = HighBitRecovery(camera_type="IMX686", noise_code="p")
    hbr.get_lut([6400])
    hbr_err = _hbr_card_check(dev, hbr, (LRID_CROPS, 4, PATCH, PATCH))
    moved = _params_moved(tr, run, run["hyper"]["learning_rate"])
    out["imx686_pmn"] = dict(_summary(run, obs, wall, launches["imx686_pmn"], moved),
                             sna_calls=obs.sna_calls, pasted_crops_first=int(mask.sum()),
                             hbr_card_vs_cpu=hbr_err)
    keep["imx686_mix"] = (tr, tr._train_batch(_collate_one(tr.dataset_train, 0)))
    print(f"IMX686 PMN: --mode trainonly, {n} steps in {wall:.2f} s, {pasted} batches "
          f"pasted; HBR card vs cpu {hbr_err:.2e}; params moved by up to {moved}", flush=True)

    # --- SonyA7S2 PMN (host HBR) and SFRN ----------------------------------
    for rel, mode in (("SonyA7S2/PMN", "train"), ("SonyA7S2/SFRN", "trainonly")):
        root = tempfile.mkdtemp(prefix="pnnp_sony_", dir=sid)
        run = _recipe_runfile(rel, root, sid, epochs=TRAIN_EPOCHS, H=MOSAIC_H, W=MOSAIC_W)
        if mode == "train":  # the eval leg over the SID 250 split (no ELD fixture)
            run["dst_eval"] = dict(run["dst_eval"], dataset="SID_Dataset", dstname="SID",
                                   ratio_list=[250], command="")
        key = rel.split("/")[1].lower()
        hosted = _HostHBRCount()
        with hosted:
            tr, obs, wall, launches[f"sony_{key}"] = _run_recipe(run, root, mode)
        moved = _params_moved(tr, run, run["hyper"]["learning_rate"])
        out[f"sony_{key}"] = dict(_summary(run, obs, wall, launches[f"sony_{key}"], moved),
                                  host_hbr_items=hosted.n, synth_keys=list(tr.synth_keys))
        if key == "sfrn":
            _check(hosted.n == len(obs.losses) and tuple(tr.synth_keys) == ("hr", "lr"),
                   f"SFRN: host HBR on {hosted.n} items, synth keys {tr.synth_keys}")
        else:
            _check(obs.sna_calls == len(obs.losses) and len(obs.legs) == TRAIN_EPOCHS + 4,
                   f"Sony PMN: SNA {obs.sna_calls}, legs {obs.legs}")
        keep[f"sony_{key}"] = (tr, tr._train_batch(_collate_one(tr.dataset_train, 0)))
        print(f"Sony {key.upper()}: --mode {mode}, {len(obs.losses)} steps in {wall:.2f} s; "
              f"host HBR on {hosted.n} items; legs {obs.legs}; launches "
              f"{launches[f'sony_{key}']}; params moved by up to {moved}", flush=True)
    return launches, out, keep


class _HostHBRCount:
    """Counts the SonyA7S2 datasets' host HBR calls (MixDataset._host_hbr)."""

    def __enter__(self):
        from pnnp_tpu_torch.data.datasets import MixDataset

        self.n, self._f = 0, MixDataset._host_hbr

        def counted(ds, crops, iso):
            self.n += 1
            return self._f(ds, crops, iso)
        MixDataset._host_hbr = counted
        return self

    def __exit__(self, *exc):
        from pnnp_tpu_torch.data.datasets import MixDataset

        MixDataset._host_hbr = self._f


def _collate_one(ds, i):
    from pnnp_tpu_torch.data import collate

    return collate([ds[i]])


def phase_baseline_timings(dev, keep):
    """The bf16 train step with each new synth on its recipe's own batch
    (Sony Mix 8x512^2, IMX686 Mix 12x512^2, SFRN 8x512^2), split; the bf16
    eval step at the IMX686 frame with the SSIM kernel's share; and the
    host loader at the runfiles' 4 workers, alone and feeding the step, for
    IMX686_Dataset / IMX686_Mix_Dataset and Mix_Dataset / SFRN_Dataset."""
    from pnnp_tpu_torch.data.phone import IMX686Dataset
    from pnnp_tpu_torch.models import UNetSeeInDark
    from pnnp_tpu_torch.train import make_adam, make_train_step
    from pnnp_tpu_torch.train.steps import make_eval_metrics_step

    steps = {}
    for name, key in (("mix_sony", "sony_pmn"), ("mix_imx686", "imx686_mix"),
                      ("sfrn_sony", "sony_sfrn")):
        tr, batch = keep[key]
        net = UNetSeeInDark(nf=32, generator=torch.Generator().manual_seed(0)).to(dev)
        opt = make_adam(net.parameters())
        step = make_train_step(lambda e: 1e-4, tr.synth, clip_mode=tr.dst.get("clip", 0),
                               bf16=True)
        gen = torch.Generator(device=dev).manual_seed(0)
        call = lambda: step(net, opt, batch, gen, 1)
        ms = _time_ms(call, warmup=3, iters=10)
        n, _, h, w = batch["hr"].shape
        flops = 3 * _unet_flops_per_pixel(32) * n * h * w
        steps[name] = {"batch": [n, 4, h, w], "ms": ms, "split_ms": _split_ms(step, net, opt,
                                                                              batch, gen),
                       "bound_ms": flops / BF16_FLOP_PER_S * 1e3}
        print(f"train step bf16, {name} synth, {[n, 4, h, w]}: {ms:.3f} ms "
              f"(split {steps[name]['split_ms']})", flush=True)
        del net, opt, step, call
        torch.cuda.empty_cache()

    # the eval step at the IMX686 frame, bf16, and its SSIM share
    h, w = IMX686[0], IMX686[1]
    rng = np.random.default_rng(3)
    lr = torch.from_numpy(rng.uniform(0, 0.4, (1, h, w * 4)).astype(np.float32)).to(dev)
    hr = torch.from_numpy(rng.uniform(0, 1, (1, h, w * 4)).astype(np.float32)).to(dev)
    net = UNetSeeInDark(nf=32, dtype=torch.bfloat16,
                        generator=torch.Generator().manual_seed(0)).to(dev).eval()
    fused = make_eval_metrics_step(net)
    call = lambda: fused(lr, hr, 1.0, correct=False)
    eval_ms = _time_ms(call, warmup=3, iters=10)
    prof = _profile(call, eval_ms)
    ssim_ms = prof["by_class_ms"].get("ssim kernel", 0.0)
    eval_imx = {"frame": [1, h, w, 4], "ms": eval_ms, "mpix_s": h * w * 4 / 1e6 / (eval_ms / 1e3),
                "ssim_ms": ssim_ms, "ssim_share": ssim_ms / eval_ms, "profile": prof}
    print(f"eval step bf16 at the IMX686 frame: {eval_ms:.3f} ms, SSIM {ssim_ms:.4f} ms",
          flush=True)
    del net, fused, call
    torch.cuda.empty_cache()

    # host loaders: the IMX686 paired set beside its Mix set (12 crops of a
    # 3472x4624 frame), and the Sony Mix / SFRN sets with host HBR
    tr_imx = keep["imx686_mix"][0]
    paired = IMX686Dataset(dict(tr_imx.dst_train, dataset="IMX686_Dataset"), seed=tr_imx.seed)
    loaders = {
        "IMX686_Dataset": _loader_pace(tr_imx, n=36, dataset=paired),
        "IMX686_Mix_Dataset": _loader_pace(tr_imx, n=36),
        "Mix_Dataset": _loader_pace(keep["sony_pmn"][0], n=32),
        "SFRN_Dataset": _loader_pace(keep["sony_sfrn"][0], n=32),
    }
    return {"train_step_bf16": steps, "eval_step_imx686_bf16": eval_imx,
            "loader_ms_per_batch": loaders}


# ------------------------------------------------------------------ NoiseFlow
FLOW_LR = 2e-3  # the NoiseFlow.yml runfiles' learning_rate, held fixed
FLOW_CHECK = (8, 64, 64)  # card against CPU: 8 crops of 64^2 (the NoiseFlow.yml patch)
# tests/test_nf_kld_parity.py's budget and bars (trained ISOs; held-out 6400 above 0.3)
VALIDATE_NF_ARGS = ["--steps", "4000", "--patch", "16", "--batch", "4", "--eval-frames", "8"]
VALIDATE_NF_BARS = {800: 0.08, 1600: 0.06, 3200: 0.14, 12800: 0.9}


def _flow_off_init(seed=0):
    """NoiseFlow at the production arch from its init law at ``seed``, every
    learned leaf and BatchNorm stat moved off init by seeded numpy draws
    (the frozen permutations, signs and the ISO ladder kept), so that the
    couplings' networks shape the output."""
    from pnnp_tpu_torch.models import NoiseFlow

    return _off_init(NoiseFlow(generator=torch.Generator().manual_seed(seed)), seed)


def _off_init(module, seed):
    """``module`` with every learned leaf and BatchNorm stat moved off its
    init by seeded numpy draws (frozen permutations, signs and ISO ladders
    kept); in place, returned."""
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for name, t in list(module.named_parameters()) + list(module.named_buffers()):
            leaf = name.rsplit(".", 1)[-1]
            if leaf in ("p", "sign_s", "legal_iso"):
                continue
            if leaf == "running_var":
                v = rng.uniform(0.5, 1.5, t.shape)
            elif leaf == "scale":
                v = rng.uniform(0.05, 0.2, t.shape)
            elif leaf in ("cam_param", "logs"):
                v = rng.normal(0, 0.05, t.shape)
            elif t.dim() == 0:
                v = float(t) + rng.normal(0, 0.3)
            else:
                v = rng.normal(0, 0.1, t.shape)
            t.copy_(torch.as_tensor(v, dtype=torch.float32))
    return module


def flow_card_check(dev):
    """NoiseFlow (production arch, off-init weights) on 8 x 4 x 64 x 64 on
    the card against the CPU: forward z within 1e-5 of its largest
    magnitude, the log-det 1e-5 relative, the inverse within 1e-4 of its
    largest, the train-mode NLL 1e-5 relative and its gradients within 1e-4
    of the largest gradient (the biases before each BatchNorm have a zero
    gradient in train mode and carry f32 noise only)."""
    n, h, w = FLOW_CHECK
    rng = np.random.default_rng(0)
    noise = torch.from_numpy(rng.normal(0, 0.01, (n, 4, h, w)).astype(np.float32))
    clean = torch.from_numpy(rng.uniform(0, 0.25, (n, 4, h, w)).astype(np.float32))
    iso = torch.from_numpy(rng.choice([800.0, 1600.0, 3200.0, 12800.0], n).astype(np.float32))
    res = {}
    for d in (torch.device("cpu"), dev):
        nf = _flow_off_init().to(d)
        x, c, i = noise.to(d), clean.to(d), iso.to(d)
        with torch.no_grad():
            z, ldj = nf.forward(x, c, i)
            back = nf.inverse(z, c, i)
        nll, _ = nf.loss(x, c, i, train=True)
        nll.backward()
        res[d.type] = (z.cpu(), ldj.cpu(), back.cpu(), nll.item(),
                       {k: p.grad.cpu() for k, p in nf.named_parameters() if p.grad is not None})
    (zc, lc, bc, nc, gc), (zh, lh, bh, nh, gh) = res["cuda"], res["cpu"]
    rel = lambda a, b: float((a - b).abs().max() / b.abs().max())
    gmax = max(float(g.abs().max()) for g in gh.values())
    _check(gc.keys() == gh.keys() and len(gh) > 100, "flow gradients: leaves differ")
    out = {"z": rel(zc, zh), "logdet": rel(lc, lh), "inverse": rel(bc, bh),
           "nll": abs(nc - nh) / abs(nh),
           "grad_of_max": max(float((gc[k] - g).abs().max()) for k, g in gh.items()) / gmax}
    _check(out["z"] <= 1e-5 and out["logdet"] <= 1e-5 and out["inverse"] <= 1e-4
           and out["nll"] <= 1e-5 and out["grad_of_max"] <= 1e-4,
           f"NoiseFlow card vs cpu: {out}")
    return out


def _flow_batch(dev, n, p, seed=0):
    """(lr, hr, ratio, iso) on the card: clean in [0, 0.25], pgrq noise at
    ISO 3200, ratio 1 (the NoiseFlow trainer's residual is lr - hr)."""
    from pnnp_tpu_torch.physics import calibration as calib
    from pnnp_tpu_torch.physics.noise import generate_noisy

    t = calib.ISO_TABLES["SonyA7S2"]
    i = calib.iso_index("SonyA7S2", 3200)
    full = lambda v: torch.full((n,), float(v), device=dev)
    params = dict(K=full(t["Kmax"][i]), sigTL=full(t["sigTL"][i]), sigR=full(t["sigR"][i]),
                  sigGs=full(t["sigGs"][i]), lam=full(t["lam"][i]), q=full(t["q"]),
                  bias=torch.zeros((n, 4), device=dev), ratio=full(1.0), wp=full(t["wp"]),
                  bl=full(t["bl"]))
    gen = torch.Generator(device=dev).manual_seed(seed)
    hr = torch.rand((n, 4, p, p), generator=gen, device=dev) * 0.25
    return generate_noisy(gen, hr, params, "pgrq", ori=True), hr, full(1.0), full(3200.0)


def phase_noiseflow(dev, base):
    """NoiseFlow end to end on the fixtures ``phase_baselines`` built under
    ``base``: ``trainer_nf.main --kind noise_flow`` of SonyA7S2/NoiseFlow.yml
    (SID pairs, 256 crops of 64^2 per step) and IMX686/NoiseFlow.yml (LRID
    pairs, 384 crops, its ``small`` quarter), 2 epochs at the runfiles' lr
    held fixed; then SonyA7S2/NF.yml and IMX686/NF.yml ``--mode train`` on
    those checkpoints (``NF_Syn``, UNetSeeInDark nf=32, 8 / 12 crops of
    512^2, one epoch, an eval leg, ``evaltest``). Returns (SSIM launches by
    run, what was checked, the NF.yml trainers and batches for the
    timings)."""
    import yaml

    import pnnp_tpu_torch.trainer_nf as NF
    from pnnp_tpu_torch.models import NoiseFlow, build_proxy
    from pnnp_tpu_torch.train import CheckpointManager, load_any

    out, launches, keep, ckpts = {}, {}, {}, {}
    lrid, sid = os.path.join(base, "lrid"), os.path.join(base, "sid")
    crops = {"sony": 256, "imx686": 384}
    for key, rel, fixture in (("sony", "SonyA7S2/NoiseFlow", sid),
                              ("imx686", "IMX686/NoiseFlow", lrid)):
        root = tempfile.mkdtemp(prefix=f"pnnp_{key}_flow_", dir=fixture)
        run = _recipe_runfile(rel, root, fixture, epochs=TRAIN_EPOCHS,
                              extra_command="small" if key == "imx686" else "")
        _check(run["arch"]["name"] == "NoiseFlow" and run["dst_train"]["patch_size"] == 64
               and run["dst_train"]["crop_per_image"] == crops[key], f"{rel}: not at full width")
        yml = os.path.join(root, "flow.yml")
        with open(yml, "w") as f:
            yaml.safe_dump(run, f)
        lines, steps, scores = [], [], {}
        log, make_step, save = NF.log, NF.make_nf_train_step, CheckpointManager.save

        def timed_step(*a, **k):
            step = make_step(*a, **k)

            def run_step(opt, lr_img, *b):
                start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                start.record()
                m = step(opt, lr_img, *b)
                end.record()
                steps.append((start, end, float(m["nll"]), tuple(lr_img.shape)))
                return m
            return run_step

        def scored(mgr, epoch, params, batch_stats=None, eval_psnr=None):
            scores[epoch] = (eval_psnr, batch_stats)
            return save(mgr, epoch, params, batch_stats, eval_psnr)

        NF.log = lambda s, *a, **k: (lines.append(str(s)), log(s, *a, **k))
        NF.make_nf_train_step, CheckpointManager.save = timed_step, scored
        cwd = os.getcwd()
        os.chdir(root)
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            nf = NF.main(["-f", yml, "--kind", "noise_flow"])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            os.chdir(cwd)
            NF.log, NF.make_nf_train_step, CheckpointManager.save = log, make_step, save
        text = "\n".join(lines)
        epochs = re.findall(r"Epoch (\d+): nll/dim=(\S+) \(", text)
        nlls = [float(v) for _, v in epochs]
        _check(isinstance(nf.model, NoiseFlow) and nf.kind == "noise_flow"
               and all(p.device.type == dev.type for p in nf.model.parameters()),
               f"{rel}: not a NoiseFlow on the card")
        _check([int(e) for e, _ in epochs] == list(range(1, TRAIN_EPOCHS + 1))
               and all(math.isfinite(v) for v in nlls), f"{rel}: epoch NLLs {epochs}")
        # falling: the trained flow's NLL on one fixed train batch against
        # its init's (the epoch means move with each item's random ratio)
        init = build_proxy(dict(run["arch"], name="NoiseFlow"),
                           generator=torch.Generator().manual_seed(nf.seed)).to(dev)
        lr_img, hr_img, ratio, iso = nf._to_device(_collate_one(nf.dataset_train, 0))
        rb = ratio.reshape(-1, 1, 1, 1)
        with torch.no_grad():
            fixed = [float(m.loss((lr_img - hr_img) / rb, hr_img / rb, iso)[0])
                     for m in (init, nf.model)]
        _check(fixed[1] < fixed[0], f"{rel}: NLL on a fixed batch {fixed} (init, trained)")
        n_steps = len(nf.dataset_train) * TRAIN_EPOCHS
        _check(len(steps) == n_steps and all(math.isfinite(s[2]) for s in steps)
               and {s[3] for s in steps} == {(crops[key], 4, 64, 64)},
               f"{rel}: {len(steps)} of {n_steps} steps, shapes {({s[3] for s in steps})}")
        _check(sorted(scores) == list(range(1, TRAIN_EPOCHS + 1))
               and all(math.isfinite(s) for s, _ in scores.values()),
               f"{rel}: epochs scored {scores.keys()}")
        best = load_any(nf.ckpt.best_path())
        _check(best["meta"]["epoch"] == max(scores, key=lambda e: scores[e][0]),
               f"{rel}: best is epoch {best['meta']['epoch']}, scores {scores}")
        var = best["batch_stats"]["unc_1"]["net"]["bn1"]["var"]
        stats_moved = float(np.abs(var - 1.0).max())
        _check(stats_moved > 1e-4, f"{rel}: batch_stats did not move ({stats_moved})")
        step_ms = [a.elapsed_time(b) for a, b, *_ in steps]
        ckpts[key] = nf.ckpt.best_path()
        out[f"{key}_noiseflow"] = {
            "wall_s": wall, "steps": len(steps), "step_ms_median": statistics.median(step_ms),
            "epoch_nll": nlls, "fixed_batch_nll_init_trained": fixed,
            "kld_sym": {e: -s for e, (s, _) in scores.items()},
            "best_epoch": best["meta"]["epoch"], "batch_stats_moved": stats_moved}
        print(f"{rel}: trainer_nf --kind noise_flow, {len(steps)} steps of "
              f"{crops[key]}x64^2 in {wall:.2f} s (median step {statistics.median(step_ms):.2f} "
              f"ms); epoch NLL {nlls}; fixed-batch NLL init/trained {fixed}; KLD "
              f"{out[f'{key}_noiseflow']['kld_sym']}; best epoch "
              f"{best['meta']['epoch']}; batch_stats moved by {stats_moved:.4f}", flush=True)
        del nf
        torch.cuda.empty_cache()

    # --- NF.yml --mode train on those checkpoints ----------------------------
    for key, rel, fixture, n_crops in (("sony_nf", "SonyA7S2/NF", sid, CROPS),
                                       ("imx686_nf", "IMX686/NF", lrid, LRID_CROPS)):
        imx = key.startswith("imx686")
        root = tempfile.mkdtemp(prefix=f"pnnp_{key}_", dir=fixture)
        run = _recipe_runfile(rel, root, fixture, epochs=1, extra_command="small" if imx else "")
        ckpt = ckpts["imx686" if imx else "sony"]
        run["proxy_checkpoint"] = ckpt
        if not imx:  # the eval leg over the SID 250 split (no ELD fixture)
            run["dst_eval"] = dict(run["dst_eval"], dataset="SID_Dataset", dstname="SID",
                                   ratio_list=[250], command="")
        samples, sample = [], NoiseFlow.sample

        def sampled(self, clean, iso, generator, eps_std=None):
            samples.append((tuple(clean.shape), clean.device.type))
            return sample(self, clean, iso, generator, eps_std)

        NoiseFlow.sample = sampled
        try:
            tr, obs, wall, launches[key] = _run_recipe(run, root, "train")
        finally:
            NoiseFlow.sample = sample
        n = len(obs.losses)
        text = "\n".join(obs.lines)
        psnrs = [float(v) for v in re.findall(r"Epoch -?\d+: PSNR=(\S+)", text)]
        _check(f"Loaded proxy checkpoint {ckpt}" in text, f"{rel}: flow checkpoint not loaded")
        _check(isinstance(tr.proxy, NoiseFlow) and not tr.proxy.training
               and all(p.device.type == dev.type and not p.requires_grad
                       for p in tr.proxy.parameters()), f"{rel}: the flow is not frozen on the card")
        _check(samples == [((n_crops, 4, PATCH, PATCH), dev.type)] * n,
               f"{rel}: flow samples {samples[:3]}...: not the synth of every step")
        _check(len(obs.legs) >= 2 and psnrs and all(math.isfinite(v) for v in psnrs),
               f"{rel}: eval legs {obs.legs}, PSNRs {psnrs}")
        moved = _params_moved(tr, run, run["hyper"]["learning_rate"])
        out[key] = dict(_summary(run, obs, wall, launches[key], moved), eval_psnr=psnrs)
        keep[key] = (tr, tr._train_batch(_collate_one(tr.dataset_train, 0)))
        print(f"{rel}: --mode train, {n} steps + {sum(k for k, _ in obs.legs)} eval frames in "
              f"{wall:.2f} s; legs {obs.legs}; launches {launches[key]}; params moved by up to "
              f"{moved}", flush=True)
    return launches, out, keep


def _start_tool(cmd):
    """``cmd`` (a python module run or ``-c`` script) in a process of its own
    on the same card; (process, start time)."""
    root = os.path.dirname(os.path.abspath(__file__))
    proc = subprocess.Popen([sys.executable] + cmd, cwd=root, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    return proc, time.perf_counter()


def start_validate_nf():
    """``pnnp_tpu_torch/tools/validate_nf.py`` at the budget of
    tests/test_nf_kld_parity.py in a process of its own, on the same card:
    its small steps are bound by the host, so it runs beside the ISO ladder
    (bound by the host too). Returns (process, start time)."""
    return _start_tool(["-m", "pnnp_tpu_torch.tools.validate_nf"] + VALIDATE_NF_ARGS)


def finish_validate_nf(started):
    """Wait for :func:`start_validate_nf`'s run and hold its table to
    tests/test_nf_kld_parity.py's bars."""
    proc, t0 = started
    out, err = proc.communicate(timeout=1000)
    wall = time.perf_counter() - t0
    _check(proc.returncode == 0, f"validate_nf exited {proc.returncode}: {err[-3000:]}")
    res = json.loads(out.strip().splitlines()[-1])
    by_iso = {r["iso"]: r for r in res["rows"]}
    for iso, bar in VALIDATE_NF_BARS.items():
        _check(by_iso[iso]["kld"] <= bar, f"validate_nf: ISO {iso} KLD {by_iso[iso]} over {bar}")
    _check(by_iso[6400]["heldout"] and by_iso[6400]["kld"] > 0.3,
           f"validate_nf: held-out 6400 {by_iso[6400]} interpolates")
    print(f"validate_nf {VALIDATE_NF_ARGS}: {wall:.1f} s beside the ISO ladder (training "
          f"{res['train_s']:.1f} s), KLD { {r['iso']: r['kld'] for r in res['rows']} } inside "
          f"tests/test_nf_kld_parity.py's bars", flush=True)
    return dict(res, args=VALIDATE_NF_ARGS, wall_s=wall)


def phase_noiseflow_timings(dev, keep):
    """The NoiseFlow NLL step at NoiseFlow.yml's Sony batch (256 x 64^2,
    with a profile), sampling at the NF_Syn synth's 8 x 512^2, and the bf16
    train step of SonyA7S2/NF.yml on its own batch (split)."""
    from pnnp_tpu_torch.models import NoiseFlow, UNetSeeInDark
    from pnnp_tpu_torch.train import make_adam, make_train_step
    from pnnp_tpu_torch.trainer_nf import make_nf_train_step

    nf = NoiseFlow(generator=torch.Generator().manual_seed(0)).to(dev)
    opt = make_adam(nf.parameters())
    step = make_nf_train_step(nf, lambda e: FLOW_LR)
    lr, hr, ratio, iso = _flow_batch(dev, 256, 64)
    call = lambda: step(opt, lr, hr, ratio, iso, 1)
    nll_ms = _time_ms(call, warmup=3, iters=10)
    torch.cuda.reset_peak_memory_stats()
    call()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    prof = _profile(call, nll_ms)
    clean = torch.rand((CROPS, 4, PATCH, PATCH), generator=torch.Generator(device=dev)
                       .manual_seed(1), device=dev) * 0.02
    gen = torch.Generator(device=dev).manual_seed(2)
    with torch.no_grad():
        sample_ms = _time_ms(lambda: nf.sample(clean, torch.full((1,), 3200.0, device=dev), gen),
                             warmup=3, iters=10)
    print(f"NoiseFlow NLL step at 256x4x64^2: {nll_ms:.3f} ms (peak {peak / 2**30:.2f} GiB, "
          f"idle {prof['idle_share']:.1%}); sample at {CROPS}x4x{PATCH}^2: {sample_ms:.3f} ms",
          flush=True)
    del nf, opt, step, call
    tr, batch = keep["sony_nf"]
    net = UNetSeeInDark(nf=32, generator=torch.Generator().manual_seed(0)).to(dev)
    opt = make_adam(net.parameters())
    step = make_train_step(lambda e: 1e-4, tr.synth, clip_mode=tr.dst.get("clip", 0), bf16=True)
    gen = torch.Generator(device=dev).manual_seed(0)
    train_ms = _time_ms(lambda: step(net, opt, batch, gen, 1), warmup=3, iters=10)
    split = _split_ms(step, net, opt, batch, gen)
    print(f"train step bf16, NF_Syn synth, {list(batch['hr'].shape)}: {train_ms:.3f} ms "
          f"(split {split})", flush=True)
    del net, opt, step
    torch.cuda.empty_cache()
    return {"nll_step": {"batch": [256, 4, 64, 64], "ms": nll_ms, "peak_mem_gib": peak / 2**30,
                         "profile": prof},
            "sample": {"shape": [CROPS, 4, PATCH, PATCH], "ms": sample_ms},
            "train_step_nf_syn_bf16": {"batch": list(batch["hr"].shape), "ms": train_ms,
                                       "split_ms": split}}


# ------------------------------------------------------------ the eval's other paths
class _Counted:
    """The SSIM launches, in all and by route, and the trainer's log lines,
    of exactly the run inside the block (counts set to 0 on entry, read on
    exit, after a sync)."""

    def __enter__(self):
        import pnnp_tpu_torch.kernels.ssim as K
        import pnnp_tpu_torch.trainer as T

        self.K, self.T, self.lines, self._log = K, T, [], T.log
        T.log = lambda s, *a, **k: (self.lines.append(str(s)), self._log(s, *a, **k))[1]
        torch.cuda.synchronize()
        K.launches = 0
        K.launches_by_route = dict.fromkeys(K.ROUTES, 0)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        torch.cuda.synchronize()
        self.wall = time.perf_counter() - self.t0
        self.launches = {"ssim": self.K.launches, "by_route": dict(self.K.launches_by_route)}
        self.T.log = self._log


def _eval_entry(entry, run, root, argv, frames=2, **extra):
    """One eval entry point (``trainer.main`` or ``trainer_led.main``) over the
    fixture under ``root`` (``frames`` eval frames), with ``extra`` runfile
    keys; returns (trainer, metrics pkl, counts)."""
    import yaml

    yml = os.path.join(root, "run.yml")
    with open(yml, "w") as f:
        yaml.safe_dump(dict(run, **extra), f)
    pkl = os.path.join(root, "metrics", f"{run['model_name']}_metrics.pkl")
    if os.path.exists(pkl):
        os.remove(pkl)
    cwd = os.getcwd()
    os.chdir(root)
    try:
        with _Counted() as c:
            trainer = entry(["-f", yml] + argv)
    finally:
        os.chdir(cwd)
    with open(pkl, "rb") as f:
        metrics = pickle.load(f)
    _check(len(metrics) == frames
           and all(math.isfinite(v) for m in metrics.values() for v in m),
           f"{extra or argv}: metrics {metrics}")
    return trainer, metrics, c


def _srgb_scores(dn, hr, wb, ccm):
    """sRGB PSNR / SSIM of one frame with the plain versions, on the
    tensors' device: fast_isp, the uint8 floor, psnr and the plain ssim."""
    from pnnp_tpu_torch.ops import fast_isp, psnr, ssim

    a, b = (torch.floor(fast_isp(x, wb=wb, ccm=ccm).clamp(0, 1) * 255.0) for x in (dn, hr))
    return float(psnr(a, b)), float(ssim(a, b))


def phase_eval_paths(dev):
    """The eval's unfused and RGB side on a 2-scene 2848x4256 SID fixture at
    nf=32 (the phase-3 runfile and seeded checkpoint): ``trainer.main --mode
    eval`` with ``rgb_metrics`` (figures on), with ``disable_fused_eval``,
    ``trainer_led.main``, and ``Trainer.predict`` on a full mosaic; each
    run's SSIM launches by route. Returns (launches by path, what was
    checked, the largest |kernel - plain| of the sRGB frame)."""
    import yaml

    import pnnp_tpu_torch.trainer as T
    import pnnp_tpu_torch.trainer_led as LED
    from pnnp_tpu_torch.data.fixtures import make_sid_fixture
    from pnnp_tpu_torch.models import UNetSeeInDark, params_to_jax
    from pnnp_tpu_torch.ops import illuminance_correct, psnr, raw2bayer, tiled_apply
    from pnnp_tpu_torch.ops.metrics import rgb_quality
    from pnnp_tpu_torch.train.checkpoint import save_checkpoint

    out, launches = {}, {}
    with tempfile.TemporaryDirectory(prefix="pnnp_eval_paths_") as root:
        make_sid_fixture(root, n_scenes=2, H=MOSAIC_H, W=MOSAIC_W)
        run = _smoke_runfile(root)
        seeded = UNetSeeInDark(nf=int(run["arch"]["nf"]),
                               generator=torch.Generator().manual_seed(0))
        save_checkpoint(os.path.join(run["fast_ckpt"], f"{run['model_name']}_best_model.ckpt"),
                        params_to_jax(seeded.state_dict()), meta={"epoch": 0})

        # --- rgb_metrics, figures on: per frame the raw SSIM (hopper) and
        # the sRGB SSIM of the input and of the output (generic) ---------
        tr, m_rgb, c = _eval_entry(T.main, run, root, ["--mode", "eval"], rgb_metrics=True)
        launches["rgb"] = c.launches
        _check(c.launches["by_route"] == {"hopper": 2, "generic": 4},
               f"rgb eval: SSIM launches {c.launches}, not 1 hopper + 2 generic per frame")
        _check(tr.rgb_metrics and tr.model.conv1_1.weight.dtype == torch.bfloat16,
               "rgb eval did not serve bf16 with rgb_metrics")
        batch = tr.dataset_eval[0]
        name = batch["name"]
        lr, hr = (torch.from_numpy(batch[k]).to(dev) for k in ("lr", "hr"))
        dn = illuminance_correct(tr.eval_step(lr).clamp(0, 1), hr)[0]
        hrc = hr[0].clamp(0, 1)
        wb, ccm = tr._sample_wb_ccm(batch)
        on_card = _srgb_scores(dn, hrc, wb, ccm)
        on_cpu = _srgb_scores(dn.cpu(), hrc.cpu(), wb, ccm)
        srgb_err = abs(m_rgb[name][1] - on_card[1])
        _check(abs(m_rgb[name][0] - on_card[0]) < 1e-4 and srgb_err < TOL,
               f"rgb eval frame 0: pkl {m_rgb[name]} vs plain on the card {on_card}")
        _check(abs(on_cpu[0] - on_card[0]) < 1e-2 and abs(on_cpu[1] - on_card[1]) < TOL,
               f"sRGB scores card {on_card} vs cpu {on_cpu}")
        rgb_ms = _time_ms(lambda: rgb_quality(dn, hrc, wb, ccm), warmup=3, iters=10)
        skipped = [ln for ln in c.lines if "sample figures skipped" in ln]
        samples = os.path.join(run["result_dir"], f"samples-{run['model_name']}")
        if importlib.util.find_spec("matplotlib") is None:
            _check(len(skipped) == 1, f"figure skip logged {len(skipped)} times, not once")
            figures = skipped[0]
        else:
            want = {f"{n}_{k}" for n in m_rgb for k in ("denoised.png", "epoch-1.jpg")}
            _check(want <= set(os.listdir(samples)), f"figures {os.listdir(samples)}")
            figures = sorted(want)
        out["rgb"] = {"metrics": m_rgb, "wall_s": c.wall, "frame0_srgb_plain_card": on_card,
                      "frame0_srgb_plain_cpu": on_cpu, "rgb_quality_ms": rgb_ms,
                      "figures": figures}
        print(f"rgb eval: 2 frames in {c.wall:.2f} s, launches {c.launches}; frame 0 sRGB "
              f"{m_rgb[name]} (plain: card {on_card}, cpu {on_cpu}); rgb_quality "
              f"{rgb_ms:.3f} ms per frame; figures: {figures}", flush=True)

        # --- disable_fused_eval against the fused step --------------------
        _, m_unf, c = _eval_entry(T.main, run, root, ["--mode", "eval", "--nofig"],
                                  disable_fused_eval=True)
        launches["unfused"] = c.launches
        _check(c.launches["by_route"] == {"hopper": 2, "generic": 0},
               f"unfused eval: SSIM launches {c.launches}")
        gaps = []
        for i in range(2):
            b = tr.dataset_eval[i]
            _, m = tr._fused_eval(torch.from_numpy(b["lr"]).to(dev),
                                  torch.from_numpy(b["hr"]).to(dev),
                                  float(b["ratio"][0]), ori=False, correct=True)
            gaps.append((abs(m_unf[b["name"]][0] - float(m["psnr"])),
                         abs(m_unf[b["name"]][1] - float(m["ssim"]))))
        _check(all(g[0] < BF16_EVAL_TOL[0] and g[1] < BF16_EVAL_TOL[1] for g in gaps),
               f"disable_fused_eval vs the fused step: |dPSNR|, |dSSIM| {gaps}")
        out["unfused"] = {"metrics": m_unf, "gap_vs_fused": gaps, "wall_s": c.wall}
        print(f"disable_fused_eval: launches {c.launches}, |unfused - fused| {gaps}", flush=True)

        # --- trainer_led: the identity, corrected ---------------------------
        led, m_led, c = _eval_entry(LED.main, run, root, ["--nofig"])
        launches["led"] = c.launches
        _check(c.launches["by_route"] == {"hopper": 2, "generic": 0},
               f"LED eval: SSIM launches {c.launches}")
        led_rows = []
        for i in range(2):
            b = led.dataset_eval[i]
            lr_i, hr_i = (torch.from_numpy(b[k]).to(dev) for k in ("lr", "hr"))
            tgt = hr_i.clamp(0, 1) * 255.0
            corrected = float(psnr(illuminance_correct(lr_i.clamp(0, 1), hr_i) * 255.0, tgt))
            plain = float(psnr(lr_i.clamp(0, 1) * 255.0, tgt))
            led_rows.append((m_led[b["name"]][0], corrected, plain))
        _check(all(abs(p - cor) < 1e-4 and abs(cor - raw) > 1e-3 for p, cor, raw in led_rows),
               f"LED PSNR vs the corrected / plain input's: {led_rows}")
        out["led"] = {"metrics": m_led, "psnr_corrected_plain": led_rows, "wall_s": c.wall}
        print(f"trainer_led: launches {c.launches}, PSNR / corrected input / plain input "
              f"{led_rows}", flush=True)

        # --- Trainer.predict: a full mosaic, 20 tiles of 512^2 -------------
        raw = np.load(os.path.join(root, "00000_00_short.npy")).astype(np.float32) - 512.0
        with _Counted() as c:
            pred = tr.predict(raw, name=None)
        launches["predict"] = c.launches
        _check(pred.shape == (MOSAIC_H // 2, MOSAIC_W // 2, 4) and np.isfinite(pred).all(),
               f"predict: {pred.shape}")
        predict_ms = _time_ms(lambda: tr.predict(raw, name=None), warmup=1, iters=5)
        # its split: the tiles on the card (crop, 5 forwards of 4 tiles,
        # merge) from a packed frame already there; the rest is the copies
        # of the mosaic and of the output, and the pack
        packed = raw2bayer(torch.from_numpy(raw + 512.0).to(dev), 16383.0, 512.0)
        tiles_ms = _time_ms(lambda: tiled_apply(tr.eval_step, packed, 512, 64, tile_batch=4),
                            warmup=1, iters=5)
        del tr, led, packed
        yml = os.path.join(root, "f32.yml")
        with open(yml, "w") as f:
            yaml.safe_dump(dict(run, disable_fast_path=True), f)
        outs = {}
        for d in ("cuda", "cpu"):
            t = T.Trainer(yml, mode="eval", nofig=True, device=d)
            outs[d] = t.predict(raw[:PREDICT_CORNER[0], :PREDICT_CORNER[1]], name=None)
            del t
        scale = float(np.abs(outs["cpu"]).max())
        predict_err = float(np.abs(outs["cuda"] - outs["cpu"]).max()) / scale
        _check(predict_err <= 1e-4, f"f32 predict card vs cpu: {predict_err} of the max")
        out["predict"] = {"frame": [MOSAIC_H, MOSAIC_W], "tiles": 20, "bf16_ms": predict_ms,
                          "device_tiles_ms": tiles_ms,
                          "f32_corner": list(PREDICT_CORNER), "f32_card_vs_cpu": predict_err}
        print(f"predict: {MOSAIC_H}x{MOSAIC_W} mosaic (20 tiles of 512^2) bf16 "
              f"{predict_ms:.3f} ms (median of 5; tiles on the card {tiles_ms:.3f} ms); "
              f"launches {c.launches}; f32 card vs cpu on "
              f"{PREDICT_CORNER}: {predict_err:.2e} of the max", flush=True)
    torch.cuda.empty_cache()
    return launches, out, srgb_err


def start_ab():
    """``pnnp_tpu_torch/tools/ab_proxy_vs_physics.py`` at full width with its
    budget cut (``AB_ARGS``), in a process of its own on the same card.
    Returns (process, start time)."""
    script = ("import json\n"
              "from pnnp_tpu_torch.kernels import proxy_core\n"
              "from pnnp_tpu_torch.tools import ab_proxy_vs_physics\n"
              f"ab_proxy_vs_physics.main({AB_ARGS!r})\n"
              "print(json.dumps({'proxy_core': proxy_core.launches_by_kernel}))\n")
    return _start_tool(["-c", script])


def finish_ab(started):
    """Wait for :func:`start_ab`'s run and hold it to tests/test_ab_recipe.py's
    bars: 8 finite rows, the held-out ISO present, |mean delta| <= 0.3 dB,
    worst >= -0.6, both arms 4 dB over the input at ratio 300, ISO >= 6400."""
    proc, t0 = started
    out, err = proc.communicate(timeout=900)
    wall = time.perf_counter() - t0
    _check(proc.returncode == 0, f"A/B exited {proc.returncode}: {err[-3000:]}")
    *_, last, counts = out.strip().splitlines()
    res = json.loads(last)
    core = json.loads(counts)["proxy_core"]
    _check(core["fwd"] > 0 and core["bwd"] > 0, f"A/B: proxy core launches {core}")
    timing = json.loads(err.strip().splitlines()[-1].split("[timing] ", 1)[1])
    rows = res["rows"]
    _check(len(rows) == 8 and any(r["heldout_iso"] for r in rows)
           and all(math.isfinite(r[k]) for r in rows
                   for k in ("input_psnr", "physics_psnr", "proxy_psnr", "delta")),
           f"A/B rows {rows}")
    deltas = [r["delta"] for r in rows]
    _check(abs(sum(deltas) / len(deltas)) <= 0.3 and min(deltas) >= -0.6,
           f"A/B deltas {deltas}")
    noisy = [r for r in rows if r["ratio"] == 300 and r["iso"] >= 6400]
    _check(noisy and all(r["physics_psnr"] >= r["input_psnr"] + 4.0
                         and r["proxy_psnr"] >= r["input_psnr"] + 4.0 for r in noisy),
           f"A/B arms do not denoise at ratio 300, ISO >= 6400: {noisy}")
    print(f"A/B {AB_ARGS}: {wall:.1f} s, mean delta {res['mean_delta_db']:+.3f} dB, worst "
          f"{res['worst_delta_db']:+.3f} (tests/test_ab_recipe.py's bars held); stages "
          f"{timing}", flush=True)
    return dict(res, args=AB_ARGS, wall_s=wall, timing=timing, proxy_core_launches=core)


# ------------------------------------------------------------ packed forms, int8
INT8_SCENES = 5  # --int8 eval: 3 calibration frames (2 served bf16), 2 more after them
INT8_PSNR_TOL, INT8_SSIM_TOL = 0.5, 0.05  # int8 vs bf16 (tests/test_unet_s2d_int8.py:137)
INT8_CROP = (24, 40)  # the int8 op's card-vs-CPU check, per layer
HYBRID_CHECK = (512, 768)  # the hybrid f32 forward against the NCHW one on the card
AB_SPREAD = 0.03  # call-to-call spread of the eval step (PERF.md section 7)
VALIDATE_INT8_ARGS = ["--pct", "99.95,100"]  # the tool's default budget: 2000 steps, 8 x 256^2


def phase_packed_checks(dev):
    """The packed forms and the int8 op on the card: the hybrid packed
    forward in f32 (TF32 off) against the NCHW UNet on the card, to 1e-5 of
    the max; the int8 convolutions' int32 accumulators bit-equal to the
    CPU's at the channel counts of every quantizable layer (nf=32, real
    quantized kernels; conv9_1's up half K = 585); the int8 forward on the
    card against the CPU with the same qparams, in f32 (flipped codes
    counted, the output to 1e-3 of its norm)."""
    import pnnp_tpu_torch.models.unet_s2d_int8 as PI
    import pnnp_tpu_torch.ops.int8conv as IC
    from pnnp_tpu_torch.models import UNetSeeInDark
    from pnnp_tpu_torch.models.unet_s2d import (
        d2s,
        s2d,
        transform_params_hybrid,
        unet_hybrid_forward_packed,
    )

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    net = UNetSeeInDark(nf=32, generator=torch.Generator().manual_seed(3)).to(dev)
    with torch.no_grad():
        for p in net.parameters():
            p.mul_(5.0)  # off the tiny init, as the JAX tests
        x = torch.rand((1, 4) + HYBRID_CHECK, generator=torch.Generator().manual_seed(4)) * 0.5
        x = x.to(dev)
        ref = net(x)
        got = d2s(unet_hybrid_forward_packed(transform_params_hybrid(net, torch.float32), s2d(x),
                                             dtype=torch.float32))
    hybrid_err = float((got - ref).abs().max() / ref.abs().max())
    _check(hybrid_err <= 1e-5, f"hybrid f32 forward vs NCHW on the card: {hybrid_err} of the max")

    # real quantized kernels of every quantizable layer (QUANT_LAYERS and
    # OPTIONAL_QUANT), calibrated on a small frame on the CPU
    net_c = net.cpu()
    g1 = s2d(torch.rand((1, 4, 64, 96), generator=torch.Generator().manual_seed(5)) * 0.5)
    tp = transform_params_hybrid(net_c, torch.float32)
    qp = PI.quantize_params_int8(tp, PI.calibrate_act_scales(tp, [g1], torch.float32, pct=99.95),
                                 quant=PI.QUANT_LAYERS + PI.OPTIONAL_QUANT)
    layers = {}
    for name, layer in qp["layers"].items():
        kq = layer["kq"]
        transpose = name.startswith("upv")
        c = kq.shape[0] if transpose else kq.shape[1]
        xq = torch.randint(-127, 128, (1, c) + INT8_CROP, dtype=torch.int8,
                           generator=torch.Generator().manual_seed(c))
        op = IC.conv_transpose2x2_int8 if transpose else IC.conv3x3_int8
        want = op(xq, kq)
        got_q = op(xq.to(dev), kq.to(dev))
        torch.cuda.synchronize()
        _check(torch.equal(got_q.cpu(), want), f"int8 {name} {tuple(kq.shape)}: card != cpu")
        layers[name] = list(kq.shape)
    k585 = [n for n, s in layers.items() if s[1] * 9 == 585]
    _check(k585 == ["conv9_1u"], f"no K = 585 layer among {layers}")
    # why the int8 op is an implicit GEMM: eager conv2d on int8 CUDA tensors
    k12 = qp["layers"]["conv1_2"]["kq"].to(dev)
    x12 = torch.ones((1, k12.shape[1]) + INT8_CROP, dtype=torch.int8, device=dev)
    try:
        y = torch.nn.functional.conv2d(x12, k12, padding=1)
        torch.cuda.synchronize()
        native = f"ran, output {y.dtype} (no int32 accumulators)"
    except (RuntimeError, NotImplementedError) as e:
        native = f"refused: {str(e).splitlines()[0][:160]}"

    trace_c, trace_g = [], []
    qp_d = PI.quantize_params_int8(tp, PI.calibrate_act_scales(tp, [g1], torch.float32,
                                                               pct=99.95))
    with torch.no_grad():
        want = PI._walk(tp, g1, torch.float32, qparams=qp_d, trace=trace_c)
        to = lambda tree: {n: {k: v.to(dev) for k, v in leaf.items()} for n, leaf in tree.items()}
        got = PI._walk(to(tp), g1.to(dev), torch.float32,
                       qparams={"act_scale": qp_d["act_scale"], "layers": to(qp_d["layers"])},
                       trace=trace_g)
    flipped = sum(int((a.cpu() != b).sum()) for (_, a), (_, b) in zip(trace_g, trace_c))
    total = sum(b.numel() for _, b in trace_c)
    int8_err = float((got.cpu() - want).norm() / want.norm())
    _check(flipped <= 1e-3 * total and int8_err <= 1e-3,
           f"int8 forward card vs cpu: {int8_err} of the norm, {flipped}/{total} codes flipped")
    print(f"packed checks: eager int8 conv2d on the card {native}", flush=True)
    print(f"packed checks: hybrid f32 vs NCHW on the card {hybrid_err:.2e} of the max "
          f"({list(HYBRID_CHECK)}, nf=32); int8 op bit-exact card vs cpu at {len(layers)} "
          f"layers {layers} on {list(INT8_CROP)}; int8 forward card vs cpu (f32) "
          f"{int8_err:.2e} of the norm, {flipped}/{total} codes flipped", flush=True)
    return {"eager_int8_conv2d": native,
            "hybrid_f32_vs_nchw_of_max": hybrid_err, "int8_op_bit_exact_layers": layers,
            "int8_forward_card_vs_cpu": int8_err, "int8_codes_flipped": [flipped, total]}


def phase_int8_eval(dev, ckpt):
    """``trainer.main --mode eval --int8`` on a 5-scene 2848x4256 SID fixture
    (ELD.yml's Sony values) with ``ckpt``, the nf=32 net that
    ``validate_int8`` trained in this run: the first 3 frames calibrate (the
    first 2 served bf16), frames 3-5 are served int8; every frame's PSNR /
    SSIM held to the bf16 fused step's on the same frame, and the bf16 PSNR
    shown to move by more than that bar when the trained weights give way
    to the seeded init. Returns (launches by path, what was checked)."""
    import pnnp_tpu_torch.trainer as T
    from pnnp_tpu_torch.data.fixtures import make_sid_fixture
    from pnnp_tpu_torch.models import UNetSeeInDark
    from pnnp_tpu_torch.train.steps import make_eval_metrics_step

    out, launches = {}, {}
    with tempfile.TemporaryDirectory(prefix="pnnp_int8_") as root:
        make_sid_fixture(root, n_scenes=INT8_SCENES, H=MOSAIC_H, W=MOSAIC_W)
        run = _smoke_runfile(root)
        os.makedirs(run["fast_ckpt"], exist_ok=True)
        shutil.copy(ckpt, os.path.join(run["fast_ckpt"], f"{run['model_name']}_best_model.ckpt"))

        served = []
        real = T.Trainer._int8_eval_step

        def counted(self, lr):
            step = real(self, lr)
            served.append(step is not None)
            return step

        T.Trainer._int8_eval_step = counted
        try:
            tr, m8, c = _eval_entry(T.main, run, root, ["--mode", "eval", "--nofig", "--int8"],
                                    frames=INT8_SCENES)
        finally:
            T.Trainer._int8_eval_step = real
        launches["int8"] = c.launches
        cal = [ln for ln in c.lines if ln.startswith("int8: calibrated on 3 eval frames")]
        _check(served == [False, False] + [True] * (INT8_SCENES - 2) and len(cal) == 1
               and tr._int8_cache["step"] is not None,
               f"--int8: served int8 {served}, calibration lines {cal}")
        _check(c.launches["by_route"] == {"hopper": INT8_SCENES, "generic": 0},
               f"--int8 eval: SSIM launches {c.launches}")
        seeded = make_eval_metrics_step(UNetSeeInDark(
            nf=32, dtype=torch.bfloat16, generator=torch.Generator().manual_seed(0)).to(dev).eval())
        gaps, moved = {}, {}
        for i in range(INT8_SCENES):
            b = tr.dataset_eval[i]
            args = (torch.from_numpy(b["lr"]).to(dev), torch.from_numpy(b["hr"]).to(dev),
                    float(b["ratio"][0]))
            _, m = tr._fused_eval(*args, ori=False, correct=True)
            _, m0 = seeded(*args, ori=False, correct=True)
            gaps[b["name"]] = (m8[b["name"]][0] - float(m["psnr"]),
                               m8[b["name"]][1] - float(m["ssim"]))
            moved[b["name"]] = float(m["psnr"]) - float(m0["psnr"])
        _check(all(abs(p) < INT8_PSNR_TOL and abs(s) < INT8_SSIM_TOL for p, s in gaps.values()),
               f"--int8 vs bf16 per frame (dPSNR, dSSIM): {gaps}")
        # the bar can fail: the served net's PSNR depends on its weights
        _check(all(abs(d) > INT8_PSNR_TOL for d in moved.values()),
               f"--int8: trained minus seeded-init bf16 PSNR {moved}")
        out["int8_eval"] = {"metrics": m8, "served_int8": served, "int8_minus_bf16": gaps,
                            "trained_minus_seeded_bf16": moved, "wall_s": c.wall, "log": cal}
        print(f"--int8 eval: {INT8_SCENES} frames in {c.wall:.2f} s, served int8 {served}, "
              f"launches {c.launches}; int8 - bf16 per frame {gaps}; bf16 PSNR trained - "
              f"seeded init {moved}", flush=True)
        del seeded, tr
    torch.cuda.empty_cache()
    return launches, out


def _in_turns(arms, fn, order=None):
    """``fn(arm)`` for each arm in turns (a, b, ..., ..., b, a); per arm the
    list of its two readings and their mean."""
    runs = {a: [] for a in arms}
    for a in (order or list(arms) + list(arms)[::-1]):
        runs[a].append(fn(a))
    return {a: {"runs": v, "mean": statistics.mean(v)} for a, v in runs.items()}


# the parameter memory of the A/B's module-forward arms
_ARM_FORMAT = {"nchw": torch.contiguous_format, "nchw_cl": torch.channels_last,
               "f32_nchw": torch.contiguous_format, "f32_cl": torch.channels_last}


def phase_packed_timings(dev, batch):
    """The same-call A/Bs that set the port's memory-format defaults, and
    the int8 eval step: the bf16 fused eval step at the Sony and IMX686
    frames through the UNet in NCHW memory and in ``channels_last`` memory
    (the steps' bf16 default) (median of 10 after 3 warm-ups each, arms in
    turns, a profile of each), the W8A8 step (calibrated on the frame
    itself, pct 99.95); the bf16 train step at 8 x 512^2 ``pgrq`` on the
    main path's batch in the same two formats (in turns, split, profiled).
    Beside them the f32 eval and train steps in NCHW against
    ``channels_last`` memory."""
    import pnnp_tpu_torch.models.unet_s2d_int8 as PI
    from pnnp_tpu_torch.models import UNetSeeInDark
    from pnnp_tpu_torch.models.unet_s2d import s2d
    from pnnp_tpu_torch.train import HybridParams, make_adam, make_raw_synth, make_train_step
    from pnnp_tpu_torch.train.steps import make_eval_metrics_step, pad_to_multiple

    out = {"eval": {}, "train": {}}
    for frame, (h, w, _) in (("sony", SONY), ("imx686", IMX686)):
        rng = np.random.default_rng(1)
        lr = torch.from_numpy(rng.uniform(0, 0.4, (1, h, w * 4)).astype(np.float32)).to(dev)
        hr = torch.from_numpy(rng.uniform(0, 1, (1, h, w * 4)).astype(np.float32)).to(dev)
        # the arms: the module forward in NCHW and in channels_last memory
        # (the bf16 default), in bf16 and, beside them, in f32 (TF32 off);
        # the int8 arm's net stays as it is made
        nets = {a: UNetSeeInDark(nf=32, dtype=torch.float32 if a.startswith("f32") else
                                 torch.bfloat16, generator=torch.Generator().manual_seed(0)
                                 ).to(dev).eval()
                for a in ("nchw", "nchw_cl", "int8", "f32_nchw", "f32_cl")}
        steps = {a: make_eval_metrics_step(net, memory_format=_ARM_FORMAT[a])
                 for a, net in nets.items() if a != "int8"}
        g1 = s2d(pad_to_multiple(lr.reshape(1, h, w, 4), 16)[0].permute(0, 3, 1, 2))
        tp = HybridParams(nets["int8"])()
        qp = PI.quantize_params_int8(tp, PI.calibrate_act_scales(tp, [g1], pct=99.95))
        steps["int8"] = make_eval_metrics_step(nets["int8"], qparams=qp)
        correct = frame == "sony"  # the IMX686 evals are uncorrected
        calls = {a: (lambda s=s: s(lr, hr, 1.0, correct=correct)) for a, s in steps.items()}
        ab = _in_turns(("nchw", "nchw_cl"),
                       lambda a: _time_ms(calls[a], warmup=3, iters=10))
        ab.update(_in_turns(("f32_nchw", "f32_cl"),
                            lambda a: _time_ms(calls[a], warmup=3, iters=10)))
        ab["int8"] = {"runs": [_time_ms(calls["int8"], warmup=2, iters=10)]}
        ab["int8"]["mean"] = ab["int8"]["runs"][0]
        prof = {a: _profile(calls[a], ab[a]["mean"]) for a in calls}
        m = {a: {k: float(v) for k, v in calls[a]()[1].items()} for a in calls}
        base = ab["nchw"]["mean"]
        out["eval"][frame] = {
            "frame": [1, h, w, 4], "ms": ab, "metrics": m,
            "nchw_cl_vs_nchw": ab["nchw_cl"]["mean"] / base,
            "int8_vs_nchw": ab["int8"]["mean"] / base,
            "f32_cl_vs_f32_nchw": ab["f32_cl"]["mean"] / ab["f32_nchw"]["mean"],
            "by_class_ms": {a: p["by_class_ms"] for a, p in prof.items()},
            "idle_share": {a: p["idle_share"] for a, p in prof.items()},
            "int8_top_kernels_ms": prof["int8"]["top_kernels_ms"],
            "int8_top_ops_ms": prof["int8"]["top_ops_ms"],
        }
        print(f"eval A/B at {frame} [1, {h}, {w}, 4], ms (in turns; f32_* in f32, the rest "
              f"bf16): "
              + ", ".join(f"{a} {v['mean']:.3f} {v['runs']}" for a, v in ab.items())
              + f"; metrics {m}", flush=True)
        del nets, steps, calls, tp, qp, prof
        torch.cuda.empty_cache()

    arms = {}
    for a in ("nchw", "nchw_cl", "f32_nchw", "f32_cl"):
        net = UNetSeeInDark(nf=32, generator=torch.Generator().manual_seed(0)).to(dev)
        synth = make_raw_synth("SonyA7S2", "pgrq", ori=False, clip=True)
        step = make_train_step(lambda e: TRAIN_LR, synth, clip_mode=True,
                               bf16=not a.startswith("f32"), memory_format=_ARM_FORMAT[a])
        arms[a] = (net, make_adam(net.parameters()), step,
                   torch.Generator(device=dev).manual_seed(0))
    call = lambda a: arms[a][2](arms[a][0], arms[a][1], batch, arms[a][3], 1)
    ab = _in_turns(("nchw", "nchw_cl"),
                   lambda a: _time_ms(lambda: call(a), warmup=3, iters=10))
    ab.update(_in_turns(("f32_nchw", "f32_cl"),
                        lambda a: _time_ms(lambda: call(a), warmup=3, iters=10)))
    split = {a: _split_ms(arms[a][2], arms[a][0], arms[a][1], batch, arms[a][3]) for a in arms}
    prof = {a: _profile(lambda a=a: call(a), ab[a]["mean"]) for a in arms}
    out["train"] = {"batch": list(batch["hr"].shape), "ms": ab, "split_ms": split,
                    "nchw_cl_vs_nchw": ab["nchw_cl"]["mean"] / ab["nchw"]["mean"],
                    "f32_cl_vs_f32_nchw": ab["f32_cl"]["mean"] / ab["f32_nchw"]["mean"],
                    "by_class_ms": {a: p["by_class_ms"] for a, p in prof.items()},
                    "idle_share": {a: p["idle_share"] for a, p in prof.items()}}
    print(f"train A/B, 8 x 512^2 pgrq, ms (in turns; f32_* in f32, the rest bf16): "
          + ", ".join(f"{a} {v['mean']:.3f} {v['runs']}" for a, v in ab.items())
          + f"; split {split}", flush=True)
    del arms
    torch.cuda.empty_cache()
    # the decision rule of the defaults: another format replaces NCHW only
    # where it is faster by more than the call-to-call spread
    wins = lambda r: r < 1 - AB_SPREAD
    out["wins_over_nchw"] = {
        **{f"eval_{f}": {"nchw_cl": wins(out["eval"][f]["nchw_cl_vs_nchw"])}
           for f in out["eval"]},
        "train": {"nchw_cl": wins(out["train"]["nchw_cl_vs_nchw"])},
        "f32_cl": {k: wins(v["f32_cl_vs_f32_nchw"])
                   for k, v in [*out["eval"].items(), ("train", out["train"])]}}
    print(f"A/B decisions (faster than NCHW by more than {AB_SPREAD:.0%}): "
          f"{out['wins_over_nchw']}", flush=True)
    return out


def start_validate_int8(ckpt):
    """``pnnp_tpu_torch/tools/validate_int8.py`` at its default budget
    (2000 steps of 8 x 256^2; disjoint calibration at pct 99.95 and 100),
    then the trainer's recipe on its checkpoint (``--skip-train
    --cal-from-eval --cal-frames 3 --pct 99.95``), in processes of their own
    beside the ISO ladder. Returns (process, start time)."""
    root = os.path.dirname(os.path.abspath(__file__))
    tool = [sys.executable, "-m", "pnnp_tpu_torch.tools.validate_int8", "--ckpt", ckpt]
    script = (subprocess.list2cmdline(tool + VALIDATE_INT8_ARGS) + " && "
              + subprocess.list2cmdline(tool + ["--skip-train", "--cal-from-eval",
                                                "--cal-frames", "3", "--pct", "99.95"]))
    proc = subprocess.Popen(["sh", "-c", script], cwd=root, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    return proc, time.perf_counter()


def finish_validate_int8(started):
    """Wait for :func:`start_validate_int8`'s runs and hold them: finite rows,
    the trained bf16 net 3 dB over the input at ratio 300, the int8 mean
    delta at the serving default (pct 99.95) within 0.5 dB of bf16; the
    maxabs (pct 100) delta is reported."""
    proc, t0 = started
    out, err = proc.communicate(timeout=900)
    wall = time.perf_counter() - t0
    _check(proc.returncode == 0, f"validate_int8 exited {proc.returncode}: {err[-3000:]}")
    lines = [json.loads(ln) for ln in out.splitlines() if ln.startswith('{"metric"')]
    _check(len(lines) == 2, f"validate_int8 printed {len(lines)} result lines")
    res = dict(zip(("disjoint", "from_eval_x3"), lines))
    steps = [ln for ln in out.splitlines() if ln.startswith("step ")]
    for r in res.values():
        rows = r["rows"]
        _check(all(math.isfinite(v) for row in rows for k, v in row.items() if k != "ratio"),
               f"validate_int8 rows {rows}")
        # the serving default (pct 99.95) is held; maxabs (pct 100) is reported
        _check(abs(r["by_pct"]["99.95"]["mean"]) <= INT8_PSNR_TOL,
               f"validate_int8 deltas {r['by_pct']}")
        hi = [row for row in rows if row["ratio"] == 300]
        _check(hi and hi[0]["psnr_bf16"] >= hi[0]["psnr_in"] + 3.0,
               f"validate_int8: the trained net does not denoise {hi}")
    print(f"validate_int8 {VALIDATE_INT8_ARGS}: {wall:.1f} s beside the ISO ladder (training "
          f"{steps[-1] if steps else '-'}); disjoint x3 by pct {res['disjoint']['by_pct']}; "
          f"from-eval x3 at 99.95 {res['from_eval_x3']['by_pct']}; bf16 vs f32 "
          f"{res['disjoint']['bf16_vs_f32']} dB", flush=True)
    return dict(res, args=VALIDATE_INT8_ARGS, wall_s=wall, train_log=steps)


# ------------------------------------------------------------ multi-device
MD_RANKS = 2  # gloo ranks, all on cuda:0 (NCCL refuses two ranks on one card)
MD_SCENES, MD_EPOCHS = 2, 1
MD_HALO = 96  # the runfiles' spatial_halo default
MD_TIMEOUT = 600.0  # seconds for the whole spawn


def _md_slab(frame):
    """The per-rank SSIM slab of the sharded eval at a packed frame
    ``(H, W, 4)``: H rows, this rank's ``Wp / 2`` columns plus 6."""
    from pnnp_tpu_torch.train.steps import pad_split

    H, W, C = frame
    pl, pr = pad_split(W, 16 * MD_RANKS)
    return H, (W + pl + pr) // MD_RANKS + 6, C


def _md_paths(rank, dev, plan):
    """The sharded main path through the entry points a user calls:
    ``trainer.main --mode train`` of ELD.yml (its eval legs and ``evaltest``
    through the sharded fused step) and ``trainer_nf.main --kind
    noise_flow`` of NoiseFlow.yml, each one short epoch, under these ranks."""
    import pnnp_tpu_torch.trainer as T
    import pnnp_tpu_torch.trainer_nf as NF

    out = {}
    os.chdir(plan["eld_root"])
    t0 = time.perf_counter()
    trainer = T.main(["-f", plan["eld_yml"], "--mode", "train", "--nofig"], device=str(dev))
    torch.cuda.synchronize()
    out["eld_wall_s"] = time.perf_counter() - t0
    _check(trainer.n_data == MD_RANKS and trainer.mesh_spatial.n_spatial == MD_RANKS,
           f"ELD.yml meshes {trainer.mesh.shape} / {trainer.mesh_spatial.shape}")
    _check(trainer._fused_eval.__qualname__.startswith("make_eval_metrics_step_sharded"),
           "ELD.yml eval is not the sharded fused step")
    out["eld_train_psnr"] = trainer.train_psnr.avg
    out["eld_eval_psnr"] = trainer.eval_psnr.avg
    _check(math.isfinite(trainer.train_psnr.avg) and math.isfinite(trainer.eval_psnr.avg),
           f"ELD.yml under {MD_RANKS} ranks: psnr {out['eld_train_psnr']} / "
           f"{out['eld_eval_psnr']}")
    out["eld_params_sum"] = float(sum(p.detach().double().sum() for p in trainer.model.parameters()))
    del trainer
    os.chdir(plan["flow_root"])
    t0 = time.perf_counter()
    nf = NF.main(["-f", plan["flow_yml"], "--kind", "noise_flow"], device=str(dev))
    torch.cuda.synchronize()
    out["flow_wall_s"] = time.perf_counter() - t0
    out["flow_nll"] = nf.nll_meter.avg
    _check(math.isfinite(nf.nll_meter.avg), f"NoiseFlow.yml nll {nf.nll_meter.avg}")
    out["flow_stats_sum"] = float(sum(b.double().sum() for n, b in nf.model.named_buffers()
                                      if n.endswith("running_var")))
    del nf
    torch.cuda.empty_cache()
    return out


def _md_kernel(rank, dev):
    """The per-rank slab of the sharded step through the SSIM kernel at the
    two frames: the route is ``hopper``, the sum held to the plain version
    (rank 0; the launches here are checks, not the path's), timed against
    its bound and the plain version."""
    import pnnp_tpu_torch.kernels.ssim as K

    out = {}
    if rank != 0:
        return out
    for name, frame in (("sony", SONY), ("imx686", IMX686)):
        H, Ws, C = _md_slab(frame)
        xf, yf = _to_dev(_structured((H, Ws, C), 4), dev)
        route = K._route(H, Ws * C, C, xf.data_ptr(), yf.data_ptr())
        _check(route == "hopper", f"sharded slab {name} [{H}, {Ws * C}] takes the {route} route")
        n = C * (H - 6) * (Ws - 6)
        got, ref = float(K.ssim_flat_sum(xf, yf, C)), float(K.ssim_sum_plain(
            xf.reshape(H, Ws, C), yf.reshape(H, Ws, C)))
        err = abs(got - ref) / n
        _check(err < TOL, f"sharded slab {name}: kernel sum {got} vs plain {ref}")
        bytes_moved = 2 * xf.numel() * 4 + 8
        ops = (H - 6) * (Ws - 6) * C * SSIM_OPS_PER_WINDOW + xf.numel() * 3
        t_bytes, t_ops = bytes_moved / HBM_BYTES_PER_S * 1e3, ops / FP32_FLOP_PER_S * 1e3
        out[name] = {
            "slab": [H, Ws * C], "route": route, "max_abs_err": err,
            "ms": _loop_ms(_launcher(K, xf, yf, C, "hopper"), warmup=5, iters=100),
            "plain_ms": _loop_ms(lambda: K.ssim_flat_plain(xf, yf, C), warmup=2, iters=10),
            "bytes": bytes_moved, "ops": ops, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
        print(f"multidevice: ssim slab {name} [{H}, {Ws * C}] hopper "
              f"{out[name]['ms'] * 1e3:.1f} us (bound {out[name]['bound_ms'] * 1e3:.1f} us), "
              f"|kernel - plain| {err:.2e}", flush=True)
    return out


def _md_rank(rank, store, out_dir, plan):
    """One rank of phase_multidevice: gloo on cuda:0; writes its results to
    ``out_dir/rank<r>.json``."""
    import torch.distributed as dist

    import pnnp_tpu_torch.kernels.ssim as K
    import pnnp_tpu_torch.tools.multidevice as MD

    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=MD_RANKS)
    try:
        res = {"backend": dist.get_backend(), "device": str(dev)}
        # the path: every count set to 0 just before, read just after
        torch.cuda.synchronize()
        K.launches = 0
        K.launches_by_route = dict.fromkeys(K.ROUTES, 0)
        res["paths"] = _md_paths(rank, dev, plan)
        torch.cuda.synchronize()
        res["launches"] = {"ssim": K.launches, "by_route": dict(K.launches_by_route)}
        # the sharded eval at the full frames against the single-device
        # step, the data-parallel train step against the one-rank step
        res["eval"] = MD.eval_check(dev, {"sony": SONY[:2], "imx686": IMX686[:2]},
                                    halo=MD_HALO)
        res["train_step"] = MD.train_step_check(dev, CROPS, PATCH, 32)
        res["kernel"] = _md_kernel(rank, dev)
        dist.barrier()
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(res, f)
    finally:
        dist.destroy_process_group()


def phase_multidevice(dev):
    """ROADMAP 1.16 on the card: MD_RANKS gloo ranks, spawned, all on
    cuda:0. The path (``_md_paths``), the sharded eval at the full frames
    against the single-device step and the data-parallel train step against
    the one-rank step (``pnnp_tpu_torch/tools/multidevice.py``'s checks),
    and the per-rank SSIM slab (``_md_kernel``). Returns (SSIM launches of
    the path summed over the ranks, results)."""
    import multiprocessing as mp

    import yaml

    from pnnp_tpu_torch.data.fixtures import make_sid_fixture, place_eval_split

    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="pnnp_multidevice_") as root:
        t0 = time.perf_counter()
        infos = make_sid_fixture(root, n_scenes=MD_SCENES, H=MOSAIC_H, W=MOSAIC_W)
        place_eval_split(root, infos, 250)
        plan = {}
        eld = _train_runfile(root)
        eld["hyper"]["stop_epoch"] = MD_EPOCHS
        eld_root = os.path.join(root, "eld")
        os.makedirs(eld_root)
        flow_root = os.path.join(root, "flow")
        os.makedirs(flow_root)
        flow = _recipe_runfile("SonyA7S2/NoiseFlow", flow_root, root, epochs=MD_EPOCHS)
        for key, run, where in (("eld", eld, eld_root), ("flow", flow, flow_root)):
            plan[f"{key}_yml"] = os.path.join(where, "run.yml")
            plan[f"{key}_root"] = where
            with open(plan[f"{key}_yml"], "w") as f:
                yaml.safe_dump(run, f)
        print(f"multidevice: {MD_RANKS} gloo ranks on cuda:0 (NCCL refuses two ranks on "
              f"one card); fixture in {time.perf_counter() - t0:.1f} s", flush=True)

        ctx = mp.get_context("spawn")
        store = os.path.join(root, "store")
        t0 = time.perf_counter()
        procs = [ctx.Process(target=_md_rank, args=(r, store, root, plan))
                 for r in range(MD_RANKS)]
        for p in procs:
            p.start()
        try:
            deadline = time.monotonic() + MD_TIMEOUT
            for p in procs:
                p.join(max(deadline - time.monotonic(), 0.0))
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
        wall = time.perf_counter() - t0
        _check([p.exitcode for p in procs] == [0] * MD_RANKS,
               f"multidevice ranks exited {[p.exitcode for p in procs]}")
        ranks = []
        for r in range(MD_RANKS):
            with open(os.path.join(root, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
    by_route = {route: sum(r["launches"]["by_route"][route] for r in ranks)
                for route in ranks[0]["launches"]["by_route"]}
    launches = {"ssim": sum(r["launches"]["ssim"] for r in ranks), "by_route": by_route}
    _check(launches["ssim"] > 0 and by_route["hopper"] == launches["ssim"],
           f"sharded path SSIM launches {launches}: none, or not all hopper")
    paths = [r["paths"] for r in ranks]
    _check(len({p["eld_params_sum"] for p in paths}) == 1
           and len({p["flow_stats_sum"] for p in paths}) == 1,
           f"the ranks' trained params or batch stats differ: {paths}")
    result = {"ranks": MD_RANKS, "backend": ranks[0]["backend"], "device": ranks[0]["device"],
              "wall_s": wall, "launches": launches, "paths": paths,
              "eval": ranks[0]["eval"], "train_step": ranks[0]["train_step"],
              "kernel": ranks[0]["kernel"]}
    print(f"multidevice: {MD_RANKS} ranks in {wall:.1f} s, backend {result['backend']}; "
          f"launches {launches}; eval {json.dumps(result['eval'])}; "
          f"train step {json.dumps(result['train_step'])}", flush=True)
    return launches, result

# ------------------------------------------------ the flow library and the tools
VNM_ARGS = ["--samples", "400000"]  # validate_noise_model, cut from 2M
VNM_KL_BAR = 5e-3  # every row's kl_sym at VNM_ARGS (the JAX tool: ~1e-3 at 2M samples)
DEMO_TRAIN_ARGS = ["--steps", "200", "--patch", "128", "--eval-every", "100"]
DEMO_PNNP_ARGS = ["--proxy-steps", "200", "--unet-steps", "200", "--patch", "128"]
FULLRES_FRAMES = 2
EVAL_LOOP_ARGS = ["--frames", "4", "--camera", "SonyA7S2"]
BIJECTOR_CHECK = (4, 64, 64)  # the flow library, card against CPU
BIJECTOR_TOL = 1e-5  # of the largest magnitude of the CPU output


def _finish_tool(started, what, timeout=900):
    """(last stdout line as JSON, stdout, wall seconds) of a started tool."""
    proc, t0 = started
    out, err = proc.communicate(timeout=timeout)
    wall = time.perf_counter() - t0
    _check(proc.returncode == 0, f"{what} exited {proc.returncode}: {err[-3000:]}")
    return json.loads(out.strip().splitlines()[-1]), out, wall


def start_validate_noise_model():
    """``pnnp_tpu_torch/tools/validate_noise_model.py`` at ``VNM_ARGS`` beside
    the ISO ladder (its oracle runs on the host)."""
    return _start_tool(["-m", "pnnp_tpu_torch.tools.validate_noise_model"] + VNM_ARGS)


def finish_validate_noise_model(started):
    """Hold every row's ``kl_sym`` to ``VNM_KL_BAR``."""
    res, out, wall = _finish_tool(started, "validate_noise_model")
    _check(len(res["rows"]) == 5 and res["device"].startswith("cuda")
           and all(r["kl_sym"] <= VNM_KL_BAR for r in res["rows"]),
           f"validate_noise_model: rows {res['rows']} over {VNM_KL_BAR} or not on the card")
    print(f"validate_noise_model {VNM_ARGS}: {wall:.1f} s beside the ISO ladder\n"
          + "\n".join(out.strip().splitlines()[:-1]), flush=True)
    return dict(res, args=VNM_ARGS, wall_s=wall, bar=VNM_KL_BAR)


def start_demos():
    """``demo_train`` and ``demo_pnnp_pipeline`` at reduced steps, one after
    the other in one process of their own, beside the ISO ladder."""
    script = ("import json\n"
              "from pnnp_tpu_torch.kernels import proxy_core as PC\n"
              "from pnnp_tpu_torch.tools import demo_pnnp_pipeline, demo_train\n"
              f"a = demo_train.main({DEMO_TRAIN_ARGS!r})\n"
              "PC.launches_by_kernel = dict.fromkeys(PC.KERNELS, 0)\n"
              f"b = demo_pnnp_pipeline.main({DEMO_PNNP_ARGS!r})\n"
              "print(json.dumps({'demo_train': a, 'demo_pnnp_pipeline': b,\n"
              "                  'proxy_core': PC.launches_by_kernel}))\n")
    return _start_tool(["-c", script])


def finish_demos(started):
    """Both demos beat the noisy input (a positive PSNR gain) and their
    untrained net (the net learned); the proxy's KLD to the real dark
    frames falls."""
    res, out, wall = _finish_tool(started, "demos")
    for name in ("demo_train", "demo_pnnp_pipeline"):
        r = res[name]
        _check(r["gain_db"] > 0 and r["psnr"] > r["psnr_init"] and r["card"] != "cpu",
               f"{name}: {r}")
    pn = res["demo_pnnp_pipeline"]
    _check(pn["kld_after"] < pn["kld_before"], f"demo_pnnp_pipeline: KLD did not fall {pn}")
    core = res["proxy_core"]
    _check(core["fwd"] > 0 and core["bwd"] > 0,
           f"demo_pnnp_pipeline: proxy core launches {core}")
    print(f"demos {DEMO_TRAIN_ARGS} / {DEMO_PNNP_ARGS}: {wall:.1f} s beside the ISO ladder\n"
          + "\n".join(out.strip().splitlines()[:-1]), flush=True)
    return dict(res, wall_s=wall)


def _bijector_cases():
    """name -> (module factory, input law): every layer of the flow library
    no runfile reaches, at non-trivial widths."""
    from pnnp_tpu_torch.models import flows as fl

    g = lambda s: torch.Generator().manual_seed(s)
    return {
        "ActNorm": (lambda: fl.ActNorm(4), "normal"),
        "Squeeze": (lambda: fl.Squeeze(2), "normal"),
        "Logit": (lambda: fl.Logit(0.7), "unit"),
        "UniformDequantization": (lambda: fl.UniformDequantization(8), "int"),
        "NoiseExtraction": (fl.NoiseExtraction, "normal"),
        "AffineCouplingV2": (lambda: fl.AffineCouplingV2(4, 16, g(1)), "normal"),
        "SignalDependantNS": (lambda: fl.SignalDependantNS(4, generator=g(2)), "spline"),
        "ConditionalAffineCoupling": (lambda: fl.ConditionalAffineCoupling(4, 16, generator=g(3)),
                                      "normal"),
        "ConditionalAffine": (lambda: fl.ConditionalAffine(4, 16, generator=g(4)), "normal"),
        "ConditionalAffine(only_clean)": (
            lambda: fl.ConditionalAffine(4, 16, only_clean=True, generator=g(5)), "normal"),
        "ConditionalLinear": (lambda: fl.ConditionalLinear(4), "normal"),
        "ConditionalInvertibleConv1x1": (lambda: fl.ConditionalInvertibleConv1x1(4, g(6)),
                                         "normal"),
    }


def bijector_card_check(dev):
    """Every bijector of the flow library (``_bijector_cases``, off-init
    weights) and ``SdnModelScale`` on one seeded ``BIJECTOR_CHECK`` batch on
    the card against the CPU, f32 without TF32: the forward output, the
    log-det and the inverse each within ``BIJECTOR_TOL`` of the largest
    magnitude of the CPU's. ``UniformDequantization`` draws its uniform per
    device: its log-det and its inverse of the CPU's output are compared,
    and its card output must lie in ``[x, x + 1] / 256``. Returns {name:
    errors}."""
    from pnnp_tpu_torch.models import flows as fl

    n, h, w = BIJECTOR_CHECK
    rng = np.random.default_rng(0)
    laws = {"normal": rng.normal(0.5, 1.0, (n, 4, h, w)),
            "unit": rng.uniform(0.02, 0.98, (n, 4, h, w)),
            "spline": rng.uniform(-1.3, 1.3, (n, 4, h, w)),
            "int": rng.integers(0, 256, (n, 4, h, w))}
    laws = {k: torch.from_numpy(v.astype(np.float32)) for k, v in laws.items()}
    clean = torch.from_numpy(rng.uniform(0, 0.3, (n, 4, h, w)).astype(np.float32))
    field = lambda v: torch.tensor(v, dtype=torch.float32).reshape(n, 1, 1, 1).expand(n, 4, h, w)
    iso, cam = field([800.0, 3200.0, 100.0, 1600.0]), field([2.0, 3.0, 0.0, 4.0])
    rel = lambda a, b: float((a.cpu() - b).abs().max() / b.abs().max().clamp_min(1e-30))
    tf32 = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    try:
        for name, (make, law) in _bijector_cases().items():
            res = []  # the CPU's, then the card's
            for d in (torch.device("cpu"), dev):
                layer = _off_init(make(), 7).to(d)
                ctx = dict(clean=clean.to(d), iso=iso.to(d))
                if name.startswith("Conditional"):
                    ctx["cam"] = cam.to(d)
                x = laws[law].to(d)
                kw = ({"generator": torch.Generator(device=d).manual_seed(0)}
                      if name == "UniformDequantization" else {})
                with torch.no_grad():
                    z, ldj = layer.forward_ldj(x, **ctx, **kw)
                    z_in = res[0][0].to(d) if res and kw else z
                    res.append((z, ldj, layer.inverse(z_in, **ctx)))
            (zh, lh, bh), (zc, lc, bc) = res
            errs = {"ldj": rel(lc, lh), "inverse": rel(bc, bh)}
            if name == "UniformDequantization":
                # (x + u) / 2^bits with u in [0, 1): x + u rounds up to x + 1 in
                # f32 for u within half an ulp of 1, so the card's output is
                # held to [x, x + 1] / 2^bits, not to an exact round trip
                frac = zc.cpu() * 256.0 - laws["int"]
                _check(bool((frac >= 0).all() and (frac <= 1).all()),
                       "UniformDequantization: card output outside [x, x + 1] / 256")
            else:
                errs["z"] = rel(zc, zh)
            _check(max(errs.values()) <= BIJECTOR_TOL, f"{name} card vs cpu: {errs}")
            out[name] = errs
        with torch.no_grad():
            sh, sc = (_off_init(fl.SdnModelScale(5), 7).to(d)(clean.to(d), iso.to(d), cam.to(d))
                      for d in (torch.device("cpu"), dev))
        out["SdnModelScale"] = {"z": rel(sc, sh)}
        _check(out["SdnModelScale"]["z"] <= BIJECTOR_TOL, f"SdnModelScale: {out['SdnModelScale']}")
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    return out


def phase_tools(dev):
    """ROADMAP 1.17 on the card, in this process: ``eval_fullres`` in its
    default and ``--int8`` modes at ``FULLRES_FRAMES`` frames
    (the fused step's SSIM launches counted under ``fullres``), one Sony
    frame of its default step with the SSIM recomputed by the plain version,
    and ``bench_eval_loop`` at ``EVAL_LOOP_ARGS`` (under ``eval_loop``).
    Returns (launches by path, results)."""
    import pnnp_tpu_torch.kernels.ssim as K
    from pnnp_tpu_torch.models import UNetSeeInDark
    from pnnp_tpu_torch.tools import bench_eval_loop, eval_fullres

    t0 = time.perf_counter()
    launches, out = {}, {"eval_fullres": {}}
    with _Counted() as c:
        for mode, flags in (("default", []), ("int8", ["--int8"])):
            rows = eval_fullres.main(["--frames", str(FULLRES_FRAMES)] + flags, device=dev)
            _check(len(rows) == 2 and all(math.isfinite(r["metric_sum"]) and r["ms_per_frame"] > 0
                                          for r in rows), f"eval_fullres {mode}: {rows}")
            out["eval_fullres"][mode] = rows
    launches["fullres"] = c.launches
    want = 2 * len(eval_fullres.SHAPES) * (1 + eval_fullres.REPEATS) * FULLRES_FRAMES
    _check(c.launches["by_route"]["hopper"] == c.launches["ssim"] == want,
           f"eval_fullres: SSIM launches {c.launches}, not {want} hopper")

    # one Sony frame of the default step, its metrics by the plain versions
    net = UNetSeeInDark(nf=32, dtype=torch.bfloat16, generator=torch.Generator().manual_seed(
        eval_fullres.MODEL_SEED)).to(dev).eval()
    frames, hr = eval_fullres.make_frames(MOSAIC_H // 2, MOSAIC_W // 2, 1, dev)
    dnf, m = eval_fullres.build_step(net, "default")(frames[0], hr, 1.0, correct=True)
    H = hr.shape[1]
    hrc = hr[0].clamp(0, 1).reshape(H, -1)
    plain = float(K.ssim_flat_plain(dnf[0] * 255.0, hrc * 255.0))
    mse = float(torch.mean((dnf[0] * 255.0 - hrc * 255.0) ** 2))
    errs = {"ssim": abs(float(m["ssim"]) - plain),
            "psnr": abs(float(m["psnr"]) - 10.0 * math.log10(255.0**2 / mse))}
    _check(errs["ssim"] < TOL and errs["psnr"] < 1e-3, f"eval_fullres frame vs plain: {errs}")
    out["frame_vs_plain"] = {"ssim": float(m["ssim"]), "psnr": float(m["psnr"]),
                             "ssim_err": errs["ssim"], "psnr_err": errs["psnr"]}
    del net

    with _Counted() as c:
        rows = bench_eval_loop.main(EVAL_LOOP_ARGS, device=dev)
    launches["eval_loop"] = c.launches
    frames_n = int(EVAL_LOOP_ARGS[1])
    want = (1 + 2 * bench_eval_loop.REPEATS) * frames_n
    _check(len(rows) == 2 and c.launches["by_route"]["hopper"] == c.launches["ssim"] == want,
           f"bench_eval_loop: rows {rows}, SSIM launches {c.launches}, not {want} hopper")
    out["bench_eval_loop"] = rows
    out["wall_s"] = time.perf_counter() - t0
    print(f"tools: eval_fullres x2 modes and bench_eval_loop in {out['wall_s']:.1f} s; "
          f"launches {launches}; frame vs plain {out['frame_vs_plain']}", flush=True)
    for mode, rows in out["eval_fullres"].items():
        print(f"eval_fullres {mode}: " + "; ".join(
            f"{r['camera']} {r['ms_per_frame']:.3f} ms/frame" for r in rows), flush=True)
    print("bench_eval_loop: " + "; ".join(f"{r['mode']} {r['ms_per_frame']:.3f} ms/frame"
                                          for r in out["bench_eval_loop"]), flush=True)
    torch.cuda.empty_cache()
    return launches, out


# ------------------------------------- the Poisson law, the real-data CLIs, the tools
POISSON_LAMS = (1.0, 4.0, 16.0, 23.0, 64.0, 100.0)
POISSON_N = {"card": 1 << 22, "cpu": 1 << 20}  # draws per lam
SPLIT_SEEDS = list(range(8))  # validate_noise_model's IMX686 ISO 100 row, device seeds
SPLIT_SAMPLES = 400_000
# the golden trees: SID evaltest scenes per ratio split (the dataset's
# positional [0:40] x100, [40:80] x250, [80:] x300), their exposure pairs
GOLDEN_SID = ((40, "10s", "0.1s"), (40, "10s", "0.04s"), (1, "30s", "0.1s"))
GOLDEN_ELD = ((800, 100), (800, 200), (1600, 100), (1600, 200), (3200, 100), (3200, 200))
GOLDEN_SEED = 9
ORACLE_ROW_ARGS = ["--steps", "200", "--isos", "12800"]
ORACLE_FAMILY_ARGS = ["--steps", "200", "--isos", "12800"]
ABLATE_ARGS = ["--frames", "4", "--repeats", "3"]
PREFIX_ARGS = ["--iters", "4", "--repeats", "3"]
ROOFLINE_ARGS = ["--iters", "4", "--probe-int4"]
PREFIX_TOL = 0.10  # the full prefix against the W8A8 eval step
MARGINAL_FLOOR = -0.05  # each band's marginal, as a share of the full prefix


def _tee(fn, *args, **kw):
    """(``fn(*args, **kw)``, its standard output), the output printed too."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = fn(*args, **kw)
    print(buf.getvalue(), end="", flush=True)
    return res, buf.getvalue()


def phase_poisson(dev):
    """ROADMAP section 3.2 (``pnnp_tpu_torch/tools/check_poisson.py``): the
    Poisson sampler on the card and on the CPU against
    ``scipy.stats.poisson`` at ``POISSON_LAMS`` (mean and variance within 2%
    of lam, the pmf KLD within 4x its sampling floor); each card draw
    uncorrelated with the uniform the generator's next call gives the same
    element (|corr| < 5 / sqrt(n); bare ``torch.poisson``'s correlation
    reported beside it); ``validate_noise_model``'s IMX686 ISO 100 row split
    by noise code over ``SPLIT_SEEDS`` on the card, its ``pgrq`` row with
    bare ``torch.poisson`` on the card and with the port's sampler on the
    CPU: the card's ``pgrq`` median no higher than the CPU's largest."""
    from pnnp_tpu_torch.tools import check_poisson as CP

    t0 = time.perf_counter()
    cpu = torch.device("cpu")
    out = {}
    for name, d in (("card", dev), ("cpu", cpu)):
        rows = CP.sampler_rows(d, POISSON_LAMS, n=POISSON_N[name])
        for r in rows:
            _check(abs(r["mean_rel"]) < 0.02 and abs(r["var_rel"]) < 0.02
                   and r["kl"] < 4 * r["kl_floor"], f"Poisson sampler on the {name}: {r}")
        out[f"sampler_{name}"] = rows
    out["stream"] = CP.stream_rows(dev, POISSON_LAMS, n=1 << 20)
    for r in out["stream"]:
        _check(abs(r["corr_port"]) < 5 / math.sqrt(r["n"]), f"Poisson stream on the card: {r}")
    split = CP.split_rows(dev, SPLIT_SEEDS, SPLIT_SAMPLES)
    split += CP.split_rows(dev, SPLIT_SEEDS, SPLIT_SAMPLES, codes=("pgrq",), bare=True)
    (cpu_row,) = CP.split_rows(cpu, SPLIT_SEEDS, SPLIT_SAMPLES, codes=("pgrq",))
    card_row = next(r for r in split if r["code"] == "pgrq" and r["sampler"] == "port")
    _check(card_row["median"] <= cpu_row["max"],
           f"IMX686 ISO 100 pgrq: card median {card_row['median']} over the CPU's largest "
           f"{cpu_row['max']}")
    out.update(split=split, split_cpu=cpu_row, wall_s=time.perf_counter() - t0)
    print(f"Poisson: sampler within 2% of scipy's moments on the card and the CPU at "
          f"{POISSON_LAMS}; stream corr port / bare " + ", ".join(
              f"{r['lam']:g}: {r['corr_port']:+.4f} / {r['corr_bare']:+.4f}" for r in out["stream"])
          + "; IMX686 ISO 100 split, median (max) kl_sym over seeds "
          f"{SPLIT_SEEDS[0]}-{SPLIT_SEEDS[-1]}: " + ", ".join(
              f"{r['sampler']} {r['code']} {r['median']:.3e} ({r['max']:.3e})" for r in split)
          + f"; CPU pgrq {cpu_row['median']:.3e} ({cpu_row['max']:.3e}); "
          f"{out['wall_s']:.1f} s", flush=True)
    return out


def _golden_trees(root):
    """Full-width (2848x4256) SID evaltest and ELD trees in the decode-cache
    layout of tests/test_evaltest_harness.py (npy raws; ELD's JSON
    sidecars): one distinct long/short pair per SID ratio split, linked
    into ``GOLDEN_SID``'s 81 scenes; one ELD scene whose GT frames link the
    first long raw and whose ``GOLDEN_ELD`` frames link the first short
    one. Returns (SID root, ELD root)."""
    rng = np.random.default_rng(GOLDEN_SEED)
    src = os.path.join(root, "raw")
    os.makedirs(src)

    def raw(name, lo, hi):
        path = os.path.join(src, name + ".npy")
        np.save(path, rng.uniform(lo, hi, (MOSAIC_H, MOSAIC_W)).astype(np.float32))
        return path

    sid, eld = os.path.join(root, "SID"), os.path.join(root, "ELD")
    for d in ("long", "short"):
        os.makedirs(os.path.join(sid, d))
    fid = 0
    pairs = []
    for split, (n, le, se) in enumerate(GOLDEN_SID):
        pair = (raw(f"long{split}", 512, 16383), raw(f"short{split}", 400, 2200))
        pairs.append(pair)
        for _ in range(n):
            os.link(pair[0], os.path.join(sid, "long", f"{fid:05d}_00_{le}.npy"))
            os.link(pair[1], os.path.join(sid, "short", f"{fid:05d}_00_{se}.npy"))
            fid += 1
    scene = os.path.join(eld, "SonyA7S2", "scene-1")
    os.makedirs(scene)
    slots = [2, 3, 4, 5, 7, 8]
    for img_id in range(1, 17):
        path = os.path.join(scene, f"IMG_{img_id:04d}.npy")
        if img_id in slots:
            iso, ratio = GOLDEN_ELD[slots.index(img_id)]
            meta = {"ISO": iso, "ExposureTime": 100.0 / (iso * ratio)}
            os.link(pairs[0][1], path)
        else:  # GT at ids 1, 6, 11, 16; the rest never matched
            meta = ({"ISO": 100, "ExposureTime": 1.0} if img_id in (1, 6, 11, 16)
                    else {"ISO": 50, "ExposureTime": 1.0})
            os.link(pairs[0][0], path)
        with open(os.path.splitext(path)[0] + ".json", "w") as f:
            json.dump(meta, f)
    return sid, eld


def phase_golden(dev):
    """ROADMAP 1.18 on the card: the golden trees (``_golden_trees``) indexed
    by ``pnnp_tpu_torch/tools/get_dataset_infos.py``, a seeded nf=32
    UNetSeeInDark saved as a reference ``.pth`` state_dict, and
    ``pnnp_tpu_torch/tools/golden_parity.py --config SonyA7S2_PNNP`` with
    the config's runfile swapped, in this process, for PNNP.yml's Sony
    values on the trees (no dark-shading resources: no ``command``): exit 1
    against BASELINE.md's numbers with 5 sweeps and status ``fail``, then
    exit 0 with the config's sweeps replaced by the first run's own numbers.
    Every frame of both sweeps one ``hopper`` SSIM launch (under
    ``golden``). Returns (launches by path, what was checked)."""
    import yaml

    from pnnp_tpu_torch.models import UNetSeeInDark
    from pnnp_tpu_torch.tools import golden_parity as gp
    from pnnp_tpu_torch.tools.get_dataset_infos import main as build_infos

    t0 = time.perf_counter()
    cwd, saved = os.getcwd(), gp.CONFIGS["SonyA7S2_PNNP"]
    with tempfile.TemporaryDirectory(prefix="pnnp_golden_") as root:
        sid, eld = _golden_trees(root)
        infos = os.path.join(root, "infos")
        build_infos(["--dstname", "SID", "--root_dir", sid, "--mode", "evaltest",
                     "--out_dir", infos])
        build_infos(["--dstname", "ELD", "--root_dir", eld, "--out_dir", infos])
        ckpt = os.path.join(root, "SonyA7S2_PNNP_Unet.pth")
        torch.save(UNetSeeInDark(nf=32, generator=torch.Generator().manual_seed(GOLDEN_SEED))
                   .state_dict(), ckpt)
        with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), saved["runfile"])) as f:
            run = yaml.safe_load(f)
        for key in ("dst", "dst_train", "dst_eval", "dst_test"):
            run[key] = dict(run[key], command="", root_dir=root, H=MOSAIC_H, W=MOSAIC_W)
        runfile = os.path.join(root, "PNNP_golden.yml")
        with open(runfile, "w") as f:
            yaml.safe_dump(run, f)
        argv = ["--config", "SonyA7S2_PNNP", "--ckpt", ckpt, "--infos_dir", infos]
        os.chdir(root)
        try:
            gp.CONFIGS["SonyA7S2_PNNP"] = dict(saved, runfile=runfile)
            with _Counted() as c:
                rc_fail, text = _tee(gp.main, argv + ["--workdir", os.path.join(root, "w1")],
                                     device=dev)
                fail = json.loads(text.strip().splitlines()[-1])
                with open(os.path.join("logs", f"log_{run['model_name']}.log")) as f:
                    own = gp.parse_summaries(f.read())[-len(saved["sweeps"]):]
                gp.CONFIGS["SonyA7S2_PNNP"] = dict(
                    saved, runfile=runfile,
                    sweeps=[(label, p, s) for (label, _, _), (p, s) in zip(saved["sweeps"], own)])
                rc_pass, text = _tee(gp.main, argv + ["--workdir", os.path.join(root, "w2")],
                                     device=dev)
                passed = json.loads(text.strip().splitlines()[-1])
        finally:
            gp.CONFIGS["SonyA7S2_PNNP"] = saved
            os.chdir(cwd)
    _check(rc_fail == 1 and fail == {"config": "SonyA7S2_PNNP", "status": "fail", "sweeps": 5,
                                     "failed": 5}, f"golden_parity against CONFIGS: {rc_fail} {fail}")
    _check(rc_pass == 0 and passed["status"] == "pass" and passed["sweeps"] == 5,
           f"golden_parity against its own numbers: {rc_pass} {passed}")
    _check(all(math.isfinite(p) and math.isfinite(s) for p, s in own), f"golden sweeps {own}")
    want = 2 * (sum(n for n, _, _ in GOLDEN_SID) + len(GOLDEN_ELD))
    _check(c.launches["by_route"]["hopper"] == c.launches["ssim"] == want,
           f"golden_parity: SSIM launches {c.launches}, not {want} hopper")
    out = {"sweeps": own, "fail": fail, "pass": passed, "frames_per_run": want // 2,
           "wall_s": time.perf_counter() - t0}
    print(f"golden: exit {rc_fail} against CONFIGS, {rc_pass} against the run's own numbers "
          f"{own}; {c.launches}; {out['wall_s']:.1f} s", flush=True)
    return {"golden": c.launches}, out


def phase_proxy_tools(dev, params):
    """ROADMAP 1.19 on the card: ``diagnose_proxy_fit`` on the ISO ladder's
    trained proxy (``params``, d=256), its closed-form columns (the pixel
    model variance, both heads' tail_pi / tail_b) within 1e-5 relative of
    the same tool on the CPU and the centred heads' means within 1e-5 of
    the law's scale; both oracles at ``ORACLE_*_ARGS``, their KLDs finite,
    with their wall times."""
    from pnnp_tpu_torch.tools import diagnose_proxy_fit, oracle_proxy_family, oracle_row_deconv

    t0 = time.perf_counter()
    argv = [params, "--d", "256"]
    card = diagnose_proxy_fit.main(argv, device=dev)
    cpu = diagnose_proxy_fit.main(argv + ["--cpu"])
    errs = {}
    for a, b in zip(card, cpu):
        for k in ("px_var_model", "px_tail_pi", "px_tail_b", "row_tail_pi", "row_tail_b"):
            errs[f"{a['iso']}_{k}"] = abs(a[k] - b[k]) / abs(b[k])
        for k, scale in (("mean_px", b["px_var_model"] ** 0.5), ("mean_row", b["row_std"])):
            errs[f"{a['iso']}_{k}"] = abs(a[k] - b[k]) / scale
    _check(max(errs.values()) <= 1e-5, f"diagnose_proxy_fit card vs cpu: {errs}")
    diag_s = time.perf_counter() - t0
    t1 = time.perf_counter()
    row = oracle_row_deconv.main(ORACLE_ROW_ARGS, device=dev)
    row_s = time.perf_counter() - t1
    t1 = time.perf_counter()
    fam = oracle_proxy_family.main(ORACLE_FAMILY_ARGS, device=dev)
    fam_s = time.perf_counter() - t1
    _check(all(math.isfinite(r["kld_vs_gauss"]) for r in row)
           and all(math.isfinite(r["kld"]) and math.isfinite(r["row_kld"]) for r in fam),
           f"oracles: {row} {fam}")
    out = {"diagnose": card, "diagnose_card_vs_cpu_max": max(errs.values()), "diagnose_s": diag_s,
           "oracle_row_deconv": row, "oracle_row_deconv_s": row_s,
           "oracle_proxy_family": fam, "oracle_proxy_family_s": fam_s}
    print(f"proxy tools: diagnose card vs cpu {out['diagnose_card_vs_cpu_max']:.2e} "
          f"({diag_s:.1f} s); oracle_row_deconv {ORACLE_ROW_ARGS} {row_s:.1f} s; "
          f"oracle_proxy_family {ORACLE_FAMILY_ARGS} {fam_s:.1f} s", flush=True)
    return out


def phase_int8_tools(dev, w8a8_ms):
    """ROADMAP 1.20 on the card at the Sony frame: ``ablate_int8_quantset``
    (every subset), ``profile_prefix_int8`` (its full prefix within
    ``PREFIX_TOL`` of ``w8a8_ms``, the W8A8 eval step timed in this process
    by ``phase_packed_timings``; each of its seven marginals above
    ``MARGINAL_FLOOR`` of the full prefix, since a longer prefix does more
    work),
    ``bench_int8`` (every case) and ``int8_roofline`` (the walk's FLOP
    inventory equal to the JAX tool's table; the int4 probe's JSON form)."""
    from pnnp_tpu_torch.tools import (
        ablate_int8_quantset,
        bench_int8,
        int8_roofline,
        profile_prefix_int8,
    )

    t0 = time.perf_counter()
    ablate = ablate_int8_quantset.main(ABLATE_ARGS, device=dev)
    _check([r["subset"] for r in ablate] == list(ablate_int8_quantset.SUBSETS)
           and all(r["ms_frame"] > 0 for r in ablate), f"ablate: {ablate}")
    prefix = profile_prefix_int8.main(PREFIX_ARGS, device=dev)
    full = prefix[-1][1] * 1e3
    marginals = [(b - a) * 1e3 for a, b in zip([0.0] + [t for _, t in prefix[:-1]],
                                                [t for _, t in prefix])]
    _check(all(m > MARGINAL_FLOOR * full for m in marginals)
           and abs(full - w8a8_ms) <= PREFIX_TOL * w8a8_ms,
           f"profile_prefix_int8: full prefix {full} ms, marginals {marginals}, "
           f"W8A8 step {w8a8_ms} ms")
    bench = bench_int8.main([], device=dev)
    _check(len(bench) == len(bench_int8.CASES), f"bench_int8: {bench}")
    derived = int8_roofline.inventory(ablate_int8_quantset.make_tparams(dev),
                                      torch.zeros(ablate_int8_quantset.FRAME, device=dev))
    h2, w2 = ablate_int8_quantset.FRAME[2:]
    _check(derived == int8_roofline.by_class(int8_roofline.reference_bands(h2, w2)),
           f"int8_roofline: inventory {derived}")
    bands, text = _tee(int8_roofline.main, ROOFLINE_ARGS, device=dev)
    roof = json.loads(text.strip().splitlines()[-1])
    _check(roof["int4"] == {"error": int8_roofline.NO_INT4} and len(bands) == 7,
           f"int8_roofline: {roof}")
    out = {"ablate": ablate, "prefix_ms": [(n, t * 1e3) for n, t in prefix],
           "marginals_ms": marginals, "full_prefix_ms": full, "w8a8_step_ms": w8a8_ms,
           "bench_int8": bench, "roofline": roof, "wall_s": time.perf_counter() - t0}
    print(f"int8 tools: full prefix {full:.3f} ms against the W8A8 step {w8a8_ms:.3f} ms; "
          f"{out['wall_s']:.1f} s", flush=True)
    torch.cuda.empty_cache()
    return out


# ------------------------------ the bf16 forward and proxy-step profilers, the A/Bs
PROFILE_FORWARD_ARGS = ["--iters", "4", "--repeats", "3"]
PROFILE_STEP_ARGS = ["--scan", "8", "--iters", "8"]  # the tool's defaults: bwd and step
# differ by Adam and the gradients' read, 1-2% of the step
PROFILE_SERVING_ARGS = ["--repeats", "3"]
ANCHOR_TOL = 0.10  # the full prefix against its one-piece anchor; proxy step, physics step
ABLATE_CEIL = 1.05  # an ablated forward, as a share of the base
PEAK_CEIL = 1.05  # a layer's rate, as a share of the dense bf16 peak
HALFDENSE_ERR = 4.0  # the half-dense bf16 error, as a multiple of the dense hybrid's
INT8_REL_ERR = 0.08  # int8 frames against bf16 (tests/test_unet_s2d_int8.py's random-weight bar)


def _profile_step_check(dev, step_ms):
    """An independent CUDA-event median of the ``TrainStep`` call that
    ``profile_proxy_step`` times as its ``step`` prefix."""
    from pnnp_tpu_torch.tools import profile_proxy_step

    s = profile_proxy_step.build(PROXY_D, False, dev)
    ms = _time_ms(lambda: s.step(s.net, s.opt, s.batch, s.gen, 1), warmup=3, iters=10)
    _check(abs(step_ms - ms) <= ANCHOR_TOL * ms,
           f"profile_proxy_step: step prefix {step_ms} ms, the step alone {ms} ms")
    return ms


def phase_profile_tools(dev, eval_ms, train_ms):
    """ROADMAP 1.21 on the card at the full sizes, after phase 12's timings:
    ``eval_ms`` is its bf16 fused eval step at the Sony frame, ``train_ms``
    its bf16 ``pgrq`` train step. Holds: ``profile_prefix`` in both forms,
    the full prefix within ``ANCHOR_TOL`` of the tool's one-piece anchor and
    each marginal above ``MARGINAL_FLOOR`` of it, the ``channels_last``
    anchor at or below ``eval_ms`` (the forward is a part of that step);
    the one-piece forward's device time by kernel class (torch.profiler);
    ``profile_layers``, no layer above ``PEAK_CEIL`` of the dense bf16 peak
    (a higher reading is a wrong timing; the sum of parts is printed beside
    the anchor, not held); ``profile_ablate``, each ablated forward at or
    below ``ABLATE_CEIL`` of the base; ``profile_proxy_step``, ``step``
    within ``ANCHOR_TOL`` of an independent median of the same call, each
    marginal above ``MARGINAL_FLOOR`` of it, and the physics control within
    ``ANCHOR_TOL`` of ``train_ms``;
    ``profile_proxy_synth``, the dot-vs-gather error within its bf16 bound
    and the rebuilt ``full`` sample equal to the module's within 1e-6 of its
    max on the same generator state; ``bench_halfdense``, the half-dense bf16
    error against the f32 hybrid within ``HALFDENSE_ERR`` times the dense
    hybrid's; ``bench_serving_variants`` (``channels_last``), every
    variant's frames bit-equal to the loop's, ``int8`` within
    ``INT8_REL_ERR`` of them."""
    from pnnp_tpu_torch.tools import (
        bench_halfdense,
        bench_serving_variants,
        profile_ablate,
        profile_layers,
        profile_prefix,
        profile_proxy_step,
        profile_proxy_synth,
    )

    t0 = time.perf_counter()
    out = {"eval_step_ms": eval_ms, "train_step_ms": train_ms}
    for form in profile_prefix.FORMS:
        args = PROFILE_FORWARD_ARGS + ["--form", form]
        pre = profile_prefix.main(args, device=dev)
        cum = [ms for _, ms in pre["rows"]]
        full, marginals = cum[-1], [b - a for a, b in zip([0.0] + cum[:-1], cum)]
        _check(abs(full - pre["anchor_ms"]) <= ANCHOR_TOL * pre["anchor_ms"]
               and all(m > MARGINAL_FLOOR * full for m in marginals)
               and (form == "packed" or pre["anchor_ms"] <= eval_ms),
               f"profile_prefix {form}: {pre}, marginals {marginals}, eval step {eval_ms} ms")
        fwd = profile_prefix.full_fn(form, profile_prefix.subject(
            form, profile_prefix.make_net(dev)))
        x = profile_prefix.make_input(form, dev)
        with torch.no_grad():
            prof = _profile(lambda: fwd(x), pre["anchor_ms"])
        print(f"profile_prefix {form}: full prefix {full:.3f} ms, anchor "
              f"{pre['anchor_ms']:.3f} ms, bf16 eval step {eval_ms:.3f} ms; the forward's "
              f"device ms by class {prof['by_class_ms']}, idle {prof['idle_share']:.3f}",
              flush=True)
        lay = profile_layers.main(args, device=dev)
        peak = max(r["tflops"] for r in lay["rows"] if r["tflops"] is not None)
        _check(peak <= PEAK_CEIL * BF16_FLOP_PER_S / 1e12, f"profile_layers {form}: {lay}")
        print(f"profile_layers {form}: sum of parts {lay['sum_ms']:.3f} ms beside the anchor "
              f"{lay['anchor_ms']:.3f} ms; top rate {peak:.1f} TFLOP/s", flush=True)
        abl = profile_ablate.main(args, device=dev)
        _check(all(r["ms"] <= ABLATE_CEIL * abl["base_ms"] for r in abl["rows"]),
               f"profile_ablate {form}: {abl}")
        out[form] = {"prefix": pre, "forward_profile": prof, "layers": lay, "ablate": abl}
        torch.cuda.empty_cache()

    step = profile_proxy_step.main(PROFILE_STEP_ARGS, device=dev)
    cum = {r["prefix"]: r["cum_ms"] for r in step["rows"]}
    alone = _profile_step_check(dev, cum["step"])
    _check(all(r["marginal_ms"] > MARGINAL_FLOOR * cum["step"] for r in step["rows"])
           and abs(step["physics_step_ms"] - train_ms) <= ANCHOR_TOL * train_ms,
           f"profile_proxy_step: {step}, pgrq train step {train_ms} ms")
    print(f"profile_proxy_step: step {cum['step']:.3f} ms (alone {alone:.3f}), "
          f"physics {step['physics_step_ms']:.3f} ms (phase 12: {train_ms:.3f})", flush=True)
    out["proxy_step"] = dict(step, step_alone_ms=alone)
    torch.cuda.empty_cache()

    synth = profile_proxy_synth.main(PROFILE_FORWARD_ARGS, device=dev)
    proxy, clean = profile_proxy_synth.setup(256, 8, False, dev)
    with torch.no_grad():
        ref = proxy.sample(clean, torch.tensor([profile_proxy_synth.ISO], device=dev),
                           torch.Generator(device=dev).manual_seed(4))
        got = profile_proxy_synth.build(proxy, "full")(torch.Generator(device=dev).manual_seed(4),
                                                       clean)
    full_err = float((got - ref).abs().max() / ref.abs().max())
    _check(synth["dot_vs_gather"] <= profile_proxy_synth.DOT_BOUND and full_err <= 1e-6,
           f"profile_proxy_synth: {synth}, full vs sample {full_err}")
    out["proxy_synth"] = dict(synth, full_vs_sample=full_err)

    half = bench_halfdense.main(PROFILE_FORWARD_ARGS, device=dev)
    _check(half["err_vs_f32"]["halfdense"] <= HALFDENSE_ERR * half["err_vs_f32"]["hybrid"],
           f"bench_halfdense: {half}")
    out["halfdense"] = half
    serving = bench_serving_variants.main(PROFILE_SERVING_ARGS, device=dev)
    names = [r["variant"] for r in serving]
    _check(names == ["loop", "sequential x2", "sequential x4", "graph x1", "graph x2",
                     "graph x4", "int8"]
           and all(r["max_abs_diff"] == 0.0 for r in serving if r["variant"] != "int8")
           and serving[-1]["rel_err"] <= INT8_REL_ERR, f"bench_serving_variants: {serving}")
    out["serving_variants"] = serving
    out["wall_s"] = time.perf_counter() - t0
    print(f"profile tools: {out['wall_s']:.1f} s; serving ms/frame "
          + ", ".join(f"{r['variant']} {r['ms_per_frame']:.3f}" for r in serving), flush=True)
    torch.cuda.empty_cache()
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card only",
              file=sys.stderr)
        return 2
    import pnnp_tpu_torch  # noqa: F401  (fails here outside a checkout)

    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}",
          flush=True)

    phase_build()
    max_err, grid_checks = phase_kernel_checks(dev)
    launches, main_err = phase_main_path(dev)
    train_launches, train_run, batch = phase_train_main_path(dev)
    step_check = phase_train_step_check(dev)
    # the proxy core kernels' launches of each path that runs the proxy NLL
    # on the card: every count set to 0 just before, read just after
    core_launches = {}
    _proxy_core_zero()
    proxy_checks = phase_proxy_checks(dev)
    core_launches["proxy_checks"] = _proxy_core_read()
    _check(core_launches["proxy_checks"] == {"fwd": 2, "bwd": 2},
           f"proxy loss check: proxy core launches {core_launches['proxy_checks']}")
    poisson = phase_poisson(dev)
    # validate_nf, the reduced A/B and validate_int8 run beside the ladder,
    # each in a process of its own
    # (validate_int8's checkpoint serves phase 13's --int8 eval)
    vint8_dir = tempfile.TemporaryDirectory(prefix="pnnp_validate_int8_")
    vint8_ckpt = os.path.join(vint8_dir.name, "validate_int8.ckpt")
    ladder_params = os.path.join(vint8_dir.name, "ladder_proxy.pkl")
    validate_nf, ab = start_validate_nf(), start_ab()
    vint8 = start_validate_int8(vint8_ckpt)
    vnm, demos = start_validate_noise_model(), start_demos()
    try:
        _proxy_core_zero()
        ladder = phase_iso_ladder(dev, ladder_params)
        core_launches["iso_ladder"] = _proxy_core_read()
        validate_nf = finish_validate_nf(validate_nf)
        ab = finish_ab(ab)
        vint8 = finish_validate_int8(vint8)
        vnm = finish_validate_noise_model(vnm)
        demos = finish_demos(demos)
    finally:
        for started in (validate_nf, ab, vint8, vnm, demos):
            if isinstance(started, tuple) and started[0].poll() is None:
                started[0].kill()
                started[0].wait()
    _proxy_core_zero()
    proxy_tools = phase_proxy_tools(dev, ladder_params)
    core_launches["proxy_tools"] = _proxy_core_read()
    pnnp_launches, pnnp_runs, proxy_params = phase_pnnp_paths(dev)
    core_launches["proxy_trainer"] = pnnp_runs["proxy_trainer"]["proxy_core_launches"]
    core_launches["pnnp"] = pnnp_runs["pnnp_main_path"]["proxy_core_launches"]
    core_launches["ab"] = ab["proxy_core_launches"]
    core_launches["demo_pnnp_pipeline"] = demos["proxy_core"]
    with tempfile.TemporaryDirectory(prefix="pnnp_baselines_") as base:
        base_launches, base_runs, keep = phase_baselines(dev, base)
        base_timings = phase_baseline_timings(dev, keep)
        del keep
        torch.cuda.empty_cache()
        # NoiseFlow last among the runs: the flow turns TF32 off for the process
        flow_launches, flow_runs, keep = phase_noiseflow(dev, base)
        flow_timings = phase_noiseflow_timings(dev, keep)
        del keep
    torch.cuda.empty_cache()
    flow_card = flow_card_check(dev)
    print(f"NoiseFlow card vs cpu at {FLOW_CHECK}: {flow_card}", flush=True)
    t0 = time.perf_counter()
    bijectors = bijector_card_check(dev)
    bijectors_s = time.perf_counter() - t0
    print(f"flow library card vs cpu at {BIJECTOR_CHECK} in {bijectors_s:.1f} s: {bijectors}",
          flush=True)
    # after NoiseFlow: the f32 predict turns TF32 off for the process too
    eval_launches, eval_paths, srgb_err = phase_eval_paths(dev)
    packed_checks = phase_packed_checks(dev)
    int8_launches, int8_runs = phase_int8_eval(dev, vint8_ckpt)
    vint8_dir.cleanup()
    packed_timings = phase_packed_timings(dev, batch)
    int8_tools = phase_int8_tools(dev, packed_timings["eval"]["sony"]["ms"]["int8"]["mean"])
    tools_launches, tools = phase_tools(dev)
    golden_launches, golden = phase_golden(dev)
    md_launches, multidevice = phase_multidevice(dev)
    rows, timings = phase_timings(dev)
    timings.update(phase_train_timings(dev, batch))
    _proxy_core_zero()
    proxy_timings = phase_proxy_timings(dev, batch, proxy_params)
    core_launches["proxy_timings"] = _proxy_core_read()
    _check(all(c["fwd"] > 0 and c["bwd"] > 0 for k, c in core_launches.items()
               if k not in ("pnnp", "proxy_checks")),
           f"a path that trains the proxy launched no proxy core kernel: {core_launches}")
    core_row, core_errs = phase_proxy_core(dev)
    timings.update(ssim_grid=grid_checks, train_main_path=train_run, train_step_check=step_check,
                   proxy_checks=proxy_checks, iso_ladder=ladder, **pnnp_runs,
                   proxy=proxy_timings,
                   baselines=dict(base_runs, **base_timings),
                   noiseflow=dict(flow_runs, card_vs_cpu=flow_card, validate_nf=validate_nf,
                                  **flow_timings),
                   eval_paths=eval_paths, ab_reduced=ab,
                   packed_int8=dict(checks=packed_checks, **int8_runs, ab=packed_timings,
                                    validate_int8=vint8),
                   multidevice=multidevice,
                   poisson=poisson, golden=golden, proxy_tools=proxy_tools, int8_tools=int8_tools,
                   tools=dict(tools, validate_noise_model=vnm, demos=demos,
                              flow_library_card_vs_cpu=dict(errors=bijectors,
                                                            wall_s=bijectors_s)))
    timings["profile_tools"] = phase_profile_tools(dev, timings["eval_step_ms"]["bfloat16"],
                                                   timings["train_step_ms"]["bfloat16"])

    # one row per SSIM route: the main path's (hopper) and the first version
    # (generic, rgb_quality's route); launches of each path's run (the eval
    # run, the train run's, the PNNP run's, the baseline runs' and the NF.yml
    # runs' eval legs, the rgb, unfused, LED and predict runs, the int8
    # run, the ranks' sharded path, eval_fullres's two modes,
    # bench_eval_loop and golden_parity's two sweeps) and their sum
    by_path = {"eval": launches, "train": train_launches, "pnnp": pnnp_launches,
               **base_launches, **flow_launches, **eval_launches, **int8_launches,
               "sharded": md_launches, **tools_launches, **golden_launches}
    kernels = [dict(
        name=name, route="cuda", source="pnnp_tpu_torch/csrc/ssim.cu",
        replaces="pnnp_tpu/kernels/ssim.py:39",
        launches=sum(p["by_route"][route] for p in by_path.values()),
        launches_by_path={k: p["by_route"][route] for k, p in by_path.items()},
        max_abs_err=max(max_err[route], main_err if route == "hopper" else srgb_err),
        **rows[route]) for name, route in (("ssim", "hopper"), ("ssim_generic", "generic"))]
    # the proxy NLL's kernel pair: launches of each path that runs the NLL
    # (forward and backward kernel), its largest errors against float64 (of
    # the largest magnitude), its times and bound at the main path's shape
    kernels.append(dict(
        name="proxy_core", route="cuda", source="pnnp_tpu_torch/csrc/proxy_core.cu",
        replaces=None,
        launches=sum(c["fwd"] + c["bwd"] for c in core_launches.values()),
        launches_by_path=core_launches, max_err_of_max=core_errs, **core_row))
    print(json.dumps({"timings": timings}))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
