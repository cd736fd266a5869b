"""Trainer: runfile-driven training and evaluation on the card (counterpart
of ``pnnp_tpu/trainer.py``).

Same CLI surface (``python -m pnnp_tpu_torch.trainer -f runfile --mode
{train,trainonly,eval,test,evaltest,dump}``), same YAML runfiles, same log
lines, metrics pickle and checkpoint files; a checkpoint written by either
package loads in the other.

Training keeps float32 master parameters and steps through
:class:`~pnnp_tpu_torch.train.steps.TrainStep`: the on-device synth picked
from the train dataset, as the JAX Trainer picks it (physics for
``Raw_Dataset`` and, with the LRID law, ``IMX686_Raw_Dataset``; the learned
noise model of ``arch_proxy`` for the ``Proxy_Dataset`` names (the
``pw_iso_2stage`` proxy, the paper's PNNP recipe) and the ``NF_Syn_Dataset``
names (NoiseFlow), its weights from ``proxy_checkpoint``; PMN's
shot-noise augmentation of real pairs for the ``Mix_Dataset`` names, with
HighBitRecovery of the IMX686 bias pastes on the card; black-frame shot
noise plus the real read layer for the SFRN names; or real pairs, the PMNNP
names included, as in JAX), then forward, L1, backward and Adam scaled by
``lr(epoch)``. UNetSeeInDark trains with a bf16 forward under autocast
(f32 with ``disable_fast_path: true``). ``train`` evaluates every
``plot_freq`` epochs, reloads the best weights at each SGDR period boundary,
and ends with the ``evaltest`` sweep over the best weights; ``trainonly``
trains without the eval legs.

Eval serves UNetSeeInDark in bf16 (f32 with ``disable_fast_path: true``)
through one fused step: forward, clip, illuminance correction (not for the
IMX686 datasets, as the reference's LRID trainer), PSNR and the CUDA SSIM
kernel. In the train modes it serves a bf16 copy of the master weights,
refreshed at each eval leg. The unfused branch (the plain forward, then
clip, correction, PSNR and the SSIM kernel on ``[H, W, 4]``, as
``pnnp_tpu/trainer.py:721-768``) serves eval when the runfile sets
``disable_fused_eval`` or ``rgb_metrics`` (the sRGB meters of the device ISP,
:func:`~pnnp_tpu_torch.ops.metrics.rgb_quality`), and for
:class:`~pnnp_tpu_torch.trainer_led.LEDTrainer`. Unlike JAX, which also
takes it for ``disable_fast_path`` (and for any arch but the fast UNet),
``disable_fast_path`` alone keeps the fused step here, in f32: both branches
compute the same numbers (tests/test_torch_trainer.py,
tests/test_torch_eval_rgb.py). With ``save_plot`` (no ``--nofig``) every
eval frame at epoch < 0 and every ``dump`` frame renders the 3-panel JPG and
the ``{name}_denoised.png`` through the device ISP, the figures drawn on the
host by a 4-thread pool; without matplotlib the render is skipped, logged
once per run. :meth:`Trainer.predict` is the reference's tiled full-frame
inference.

``--int8`` serves the fused eval through the W8A8 packed forward
(:mod:`pnnp_tpu_torch.models.unet_s2d_int8`), as the JAX Trainer: the first
``int8_cal_frames`` (default 3) eval frames calibrate the activation scales
(pct 99.95, max-combined), the first N - 1 served by the bf16 fused step
while they accrue; the weights are quantized once per parameter version and
serve from frame N on.

The whole UNet family trains (``DeepUNet``, ``ResUNet``, ``DeepResUNet``;
``use_dpsv`` on the deep-supervised archs, through the deep-supervision
loss); as in JAX, only UNetSeeInDark without ``use_dpsv`` evaluates through
the fused step, every other arch through the unfused branch.

Several ranks (``torchrun --nproc_per_node=N -m pnnp_tpu_torch.trainer
...``; :func:`main` initializes the process group from the environment,
:func:`~pnnp_tpu_torch.parallel.init_distributed`) run the JAX Trainer's
meshes (``pnnp_tpu/trainer.py:173-233``): training is data-parallel over
every rank (or ``world / mesh_spatial`` ranks of a ``mesh_spatial: K``
runfile), each rank loading its block of every global batch and the
gradients averaged before Adam; eval is width-sharded over every rank (or
the ``K`` ranks of a row), the fused step's
:func:`~pnnp_tpu_torch.parallel.make_eval_metrics_step_sharded` with
``spatial_halo`` columns (default 96), the unfused branch's
:func:`~pnnp_tpu_torch.parallel.spatial_eval_auto`. Each rank of a row
loads the whole eval frame and keeps its columns. Rank 0 alone logs and
writes the metrics pickle, checkpoints and figures.
"""

from __future__ import annotations

import argparse
import importlib.util
import os
import pickle
import time
from typing import Optional

import numpy as np
import torch

from pnnp_tpu_torch.config import command_of, load_runfile
from pnnp_tpu_torch.data import DataLoader, build_dataset
from pnnp_tpu_torch.models import (
    build_model,
    build_proxy,
    load_proxy_jax,
    params_from_jax,
    params_to_jax,
)
from pnnp_tpu_torch.kernels.ssim import ssim_kernel
from pnnp_tpu_torch.models.unet_s2d import s2d
from pnnp_tpu_torch.ops import fast_isp, illuminance_correct, psnr, raw2bayer, tiled_apply
from pnnp_tpu_torch.ops.metrics import rgb_quality
from pnnp_tpu_torch.parallel import (
    barrier,
    init_distributed,
    loader_shard,
    make_eval_metrics_step_sharded,
    make_mesh,
    make_sharded_train_step,
    place_batch,
    rank_seed,
    replicate,
    spatial_eval_auto,
)
from pnnp_tpu_torch.train import (
    CheckpointManager,
    build_lr_schedule,
    identity_synth,
    load_any,
    make_adam,
    make_eval_metrics_step,
    make_eval_step,
    make_mix_synth,
    make_proxy_synth,
    make_raw_synth,
    make_train_step,
    pad_to_multiple,
    params_key,
)
from pnnp_tpu_torch.utils.device import resolve_device
from pnnp_tpu_torch.utils.logging import AverageMeter, StepTimer, is_main_process, log
from pnnp_tpu_torch.utils.profiling import count, span, tracing

_TRAIN_MODES = ("train", "trainonly")


def _render_sample(imgs, jpg_path, png_path):
    """Build and save the 3-panel figure and the denoised PNG (thread-safe:
    object-oriented matplotlib only, no pyplot state)."""
    import matplotlib

    matplotlib.use("Agg", force=False)
    import matplotlib.image as mpimg
    from matplotlib.figure import Figure

    mpimg.imsave(png_path, np.clip(imgs[1], 0.0, 1.0))
    fig = Figure(figsize=(15, 5))
    axes = fig.subplots(1, 3)
    for ax, img, title in zip(axes, imgs, ("noisy", "denoised", "gt")):
        ax.imshow(np.clip(img, 0, 1))
        ax.set_title(title)
        ax.axis("off")
    fig.savefig(jpg_path, bbox_inches="tight", dpi=60)


class Parser:
    """CLI surface of the reference BaseParser (base_trainer.py:6-17)."""

    @staticmethod
    def parse(argv=None):
        p = argparse.ArgumentParser()
        p.add_argument("--runfile", "-f", default="runfiles/SonyA7S2/PNNP.yml")
        p.add_argument("--mode", "-m", default=None)
        p.add_argument("--debug", action="store_true")
        p.add_argument("--nofig", action="store_true")
        # Accepted for reference CLI parity, intentionally inert (the
        # reference's hostname->data-root remap, utils/utils.py:204-219).
        p.add_argument("--nohost", action="store_true")
        p.add_argument("--gpu", default="0")  # the card: cuda:<gpu>
        p.add_argument("--int8", action="store_true")
        return p.parse_args(argv)


class Trainer:
    _phone_eval_corrects = False  # IMX686 evals uncorrected (see _brightness_correct)

    def __init__(self, runfile: str, mode: Optional[str] = None, nofig: bool = False,
                 debug: bool = False, root_prefix: Optional[str] = None, seed: int = 1997,
                 int8: bool = False, device=None):
        self.args = load_runfile(runfile, mode=mode, root_prefix=root_prefix)
        self.mode = self.args["mode"]
        self.int8_eval = bool(int8)
        # W8A8 calibration traffic: the first N eval frames (one frame
        # calibrates worse than several, pnnp_tpu/trainer.py:114-121), served
        # through the bf16 fused step while they accrue
        self.int8_cal_frames = int(self.args.get("int8_cal_frames", 3))
        self.device = resolve_device(device)
        self.dst = self.args["dst"]
        self.hyper = self.args["hyper"]
        self.arch = self.args["arch"]
        self.model_name = self.args["model_name"]
        self.save_plot = not nofig
        self.rgb_metrics = bool(self.args.get("rgb_metrics", False))
        self._plot_pool = None  # lazy thread pool for figure renders
        self._plot_futures = []
        self._figures_skip_logged = False
        self.debug = debug
        self.seed = seed
        self.training = self.mode in _TRAIN_MODES
        self._make_meshes()

        self.logfile = f"./logs/log_{self.model_name}.log"
        self.sample_dir = os.path.join(self.args.get("result_dir", "images"),
                                       f"samples-{self.model_name}")
        os.makedirs(self.sample_dir, exist_ok=True)
        os.makedirs("./logs", exist_ok=True)
        os.makedirs("./metrics", exist_ok=True)

        # --- model ---------------------------------------------------------
        # UNetSeeInDark computes in bf16 (the JAX package's fast path: bf16
        # serving, and training of f32 master params through a bf16
        # forward); disable_fast_path computes in f32, like fast=False.
        fast = (self.arch.get("name") == "UNetSeeInDark"
                and not self.arch.get("use_dpsv", False)
                and not self.args.get("disable_fast_path", False))
        self.fast = fast
        self.dtype = torch.bfloat16 if fast else torch.float32
        # Training holds f32 master params; eval modes hold the serving
        # weights themselves. Eval legs in training serve a copy in
        # self.dtype, refreshed from the master at each leg.
        self.model = self._new_model(torch.float32 if self.training else self.dtype)
        self.eval_model = (self.model if self.model.dtype == self.dtype
                           else self._new_model(self.dtype).eval())
        self.lr_schedule = build_lr_schedule(self.hyper)

        # --- checkpoints ---------------------------------------------------
        self.ckpt = CheckpointManager(
            self.args.get("fast_ckpt", "checkpoints"),
            self.args.get("checkpoint", "saved_model"),
            self.model_name,
            save_freq=self.hyper.get("save_freq", 10),
            writer=is_main_process(),
        )
        self.ckpt.best_psnr = self.hyper.get("best_psnr", 0)
        self.last_epoch = int(self.hyper.get("last_epoch", 0))
        if self.last_epoch > 0 or self.mode != "train":
            self._try_restore()

        # --- proxy (PNNP), train modes only --------------------------------
        self.proxy = None
        arch_proxy = self.args.get("arch_proxy")
        if arch_proxy and self.training:
            self._init_proxy(arch_proxy)

        # --- datasets ------------------------------------------------------
        self.dst_train = self.args.get("dst_train")
        self.dst_eval = self.args.get("dst_eval")
        self.dst_test = self.args.get("dst_test")
        self.dataset_train = None
        self.dataset_eval = None
        if self.training and self.dst_train:
            self.dataset_train = build_dataset(self.dst_train, seed=seed)
        if self.dst_eval and self.mode != "trainonly":
            self.dataset_eval = build_dataset(self.dst_eval, seed=seed)

        # --- train step (after the datasets: the IMX686 synth reads the
        # train dataset's noiseparam calibration) --------------------------
        self.synth = self._make_synth()
        self.train_step = self.opt = None
        if self.training:
            dpsv = bool(self.arch.get("use_dpsv", False))
            if dpsv and not hasattr(self.model, "out2"):
                raise ValueError(
                    f"use_dpsv needs an arch with deep-supervision heads (DeepUNet, "
                    f"DeepResUNet), not {self.arch['name']}")
            self.train_step = make_train_step(
                self.lr_schedule, self.synth, clip_mode=self.dst.get("clip", 0),
                deep_supervision=dpsv, bf16=fast)
            self._base_train_step = self.train_step  # unsharded (parity tests)
            self.train_step = make_sharded_train_step(self.mesh, self.train_step)
            self.opt = make_adam(self.model.parameters())
        self._place_state()

        # --- eval steps ----------------------------------------------------
        # the fused step serves UNetSeeInDark without deep supervision, as
        # JAX's (pnnp_tpu/trainer.py:196-233); every other arch the unfused
        # branch
        self.eval_step = make_eval_step(self.eval_model)
        fused_arch = (self.arch.get("name") == "UNetSeeInDark"
                      and not self.arch.get("use_dpsv", False))
        self._fused_eval = (self._metrics_step() if fused_arch
                            and not self.args.get("disable_fused_eval", False) else None)
        self._int8_cache = {"key": None, "step": None, "cal": []}

        # --- meters --------------------------------------------------------
        self.train_psnr = AverageMeter("PSNR", ":2f")
        self.eval_psnr = AverageMeter("PSNR", ":2f")
        self.eval_ssim = AverageMeter("SSIM", ":4f")
        self.eval_psnr_lr = AverageMeter("PSNR", ":2f")
        self.eval_ssim_lr = AverageMeter("SSIM", ":4f")
        self.eval_psnr_dn = AverageMeter("PSNR", ":2f")
        self.eval_ssim_dn = AverageMeter("SSIM", ":4f")
        self.timer = StepTimer()
        self._print_model_log()

    def _make_meshes(self):
        """The JAX Trainer's meshes (``pnnp_tpu/trainer.py:173-195``) over
        the ranks of the process group: training on ``data`` over every
        rank, eval on ``spatial`` over every rank; a runfile's
        ``mesh_spatial: K`` (K dividing the world, smaller than it) carves
        one ``(world / K, K)`` mesh for both. One rank: the 1 x 1 mesh and
        no spatial mesh."""
        import torch.distributed as dist

        n_dev = dist.get_world_size() if dist.is_initialized() else 1
        self.spatial_halo = int(self.args.get("spatial_halo", 96))
        n_sp = int(self.args.get("mesh_spatial", 0) or 0)
        if n_sp > 1 and n_dev % n_sp == 0 and n_dev > n_sp:
            self.mesh = make_mesh(n_data=n_dev // n_sp, n_spatial=n_sp)
            self.mesh_spatial = self.mesh
        else:
            self.mesh = make_mesh()
            self.mesh_spatial = make_mesh(n_data=1, n_spatial=n_dev) if n_dev > 1 else None
        self.n_data = self.mesh.n_data

    def _metrics_step(self, qparams=None):
        """The fused eval step of the serving model: width-sharded over the
        spatial mesh, single-device without one."""
        if self.mesh_spatial is None:
            return make_eval_metrics_step(self.eval_model, qparams=qparams)
        return make_eval_metrics_step_sharded(self.eval_model, self.mesh_spatial,
                                              halo=self.spatial_halo, qparams=qparams)

    def _place_state(self):
        """The master model and the optimizer state broadcast from rank 0
        (a no-op on one rank): after init and after every checkpoint load,
        as JAX's ``_place_state``."""
        if self.mesh.size > 1:  # the optimizer is built after the first restore
            replicate(self.mesh, [self.model] + ([self.opt] if getattr(self, "opt", None) else []))

    def _place_batch(self, batch: dict) -> dict:
        """A host batch -> this data rank's rows, where the loader did not
        split the batch already (:func:`~pnnp_tpu_torch.parallel.place_batch`)."""
        return batch if self._loader_shard is not None else place_batch(self.mesh, batch)

    def _forward_full(self, lr):
        """Full-frame denoise: width-sharded with halo exchange over the
        spatial mesh, the single-device eval step without one."""
        if self.mesh_spatial is not None:
            return spatial_eval_auto(self.mesh_spatial, self.eval_step, lr,
                                     halo=self.spatial_halo)
        return self.eval_step(lr)

    def _new_model(self, dtype):
        """The arch at its N(0, 0.02) init from the trainer's seed, on the device."""
        gen = torch.Generator().manual_seed(self.seed)
        return build_model(self.arch, dtype=dtype, generator=gen).to(self.device)

    # ------------------------------------------------------------------
    def _print_model_log(self):
        lines = [
            f"Model Name:\t{self.model_name}",
            f"Architecture:\t{self.arch['name']}",
        ]
        if self.args.get("dst_train"):
            lines.append(f"TrainDataset:\t{self.args['dst_train']['dataset']}")
        if self.args.get("dst_eval"):
            lines.append(f"EvalDataset:\t{self.args['dst_eval']['dataset']}")
        cmd = command_of(self.dst)
        lines += [
            f"CameraType:\t{self.dst.get('camera_type')}",
            f"num_channels:\t{self.arch.get('nf')}",
            f"BatchSize:\t{self.hyper.get('batch_size')}",
            f"PatchSize:\t{self.dst.get('patch_size')}",
            f"LearningRate:\t{self.hyper.get('learning_rate')}",
            f"Epoch:\t\t{self.hyper.get('stop_epoch')}",
            f"Command:\t{cmd.raw} (flags: {sorted(cmd.flags()) or '-'})",
            f"Devices:\t{self.mesh.size} ({self.device}, "
            f"{str(self.dtype).replace('torch.', '')})"
            + (f", mesh data x spatial {self.mesh.n_data} x {self.mesh.n_spatial}"
               if self.mesh.size > 1 else ""),
        ]
        for line in lines:
            log(line, logfile=self.logfile, notime=True)

    def _load_params(self, params):
        """Copy a JAX parameter tree into the (master) model, in place: the
        optimizer keeps its parameters and its moments; then rank 0's copy
        goes to every rank."""
        self.model.load_state_dict(params_from_jax(params), strict=True)
        self._place_state()

    def _init_proxy(self, arch_proxy: dict):
        """The noise model of ``arch_proxy`` (the ``pw_iso_2stage`` proxy or
        NoiseFlow) at its init law from seed 0 (as the JAX Trainer's
        ``key(0)``), or the weights of ``proxy_checkpoint`` when that file
        exists (a pickle of either package; NoiseFlow's with its
        ``batch_stats``). f32 on the device, frozen, in eval mode: the
        denoiser's step does not train it. Other names leave no proxy, as
        in JAX."""
        name = str(arch_proxy.get("name", ""))
        if not any(k in name for k in ("pw_iso", "NoiseFlow", "noise_flow")):
            return
        self.proxy = build_proxy(arch_proxy, wp=float(self.dst.get("wp", 16383)),
                                 bl=float(self.dst.get("bl", 512)),
                                 generator=torch.Generator().manual_seed(0))
        proxy_ckpt = self.args.get("proxy_checkpoint")
        if proxy_ckpt and os.path.exists(proxy_ckpt):
            loaded = load_any(proxy_ckpt)
            load_proxy_jax(self.proxy, loaded["params"], loaded.get("batch_stats"))
            log(f"Loaded proxy checkpoint {proxy_ckpt}")
        self.proxy.to(self.device).eval().requires_grad_(False)

    # Keys of the host batch that each synth family reads (see _train_batch).
    _PAIR_KEYS = ("lr", "hr", "ratio")
    _MIX_KEYS = ("hr", "lr", "ratio", "iso", "wb", "black_lr")

    def _make_synth(self):
        """The on-device synthesis stage, by train dataset (the reference
        preprocess dispatch, trainer_SID.py:428-472, as the JAX Trainer's
        ``_make_synth``); sets ``synth_keys``, the batch keys it reads."""
        self.synth_keys = self._PAIR_KEYS
        if not self.dst_train or not self.training:
            return identity_synth
        name = self.dst_train["dataset"]
        cam = self.dst.get("camera_type", "SonyA7S2")
        code = self.dst.get("noise_code", "p")
        ori = bool(self.dst.get("ori", False))
        clip = self.dst.get("clip", 0)
        # dataset-level flags live in the dst_train block (falling back to
        # the shared dst block); either may be an explicit empty string
        command = self.dst_train.get("command") or self.dst.get("command") or ""
        if name in ("Raw_Dataset", "IMX686_Raw_Dataset"):
            self.synth_keys = ("hr",)
            # IMX686 (trainer_LRID.py:399-418): the ISO-6400 point
            # calibration with only-K jitter and a linear ratio ~ U(1, 16),
            # from the dataset's noiseparam h5 when it loaded one
            lrid = name == "IMX686_Raw_Dataset"
            iso = int(self.dst.get("iso", 6400)) if lrid else None
            nps = None
            if lrid:
                ds = self.dataset_train
                ds = ds.datasets[0] if hasattr(ds, "datasets") else ds
                nps = getattr(ds, "noiseparam", {}).get(iso)
            return make_raw_synth(cam, code, ori, clip, gtdn="GTdn" in command,
                                  iso=iso, lrid=lrid, noiseparam=nps)
        if name in ("Proxy_Dataset", "IMX686_Proxy_Dataset", "NF_Syn_Dataset",
                    "IMX686_NF_Syn_Dataset"):
            if self.proxy is None:
                raise RuntimeError(
                    f"{name} requires a proxy network: set arch_proxy in the "
                    "runfile (and make its checkpoint loadable)")
            self.synth_keys = ("hr", "iso")
            proxy = self.proxy

            def sample_fn(generator, clean, iso):
                # f32, whatever autocast the caller runs under; NoiseFlow
                # samples with its running BatchNorm stats
                with torch.autocast(clean.device.type, enabled=False):
                    return proxy.sample(clean.float(), iso, generator)

            if name.startswith("IMX686"):
                # LRID law (trainer_LRID.py:419-427): one dgain per batch from
                # the ladder, the ISO of the batch's own dataset
                return make_proxy_synth(sample_fn, ori=ori, ratio_ladder=(1, 2, 4, 8, 16),
                                        iso_from_batch=True)
            # Sony law (trainer_SID.py:463-472): per-example ratio ~ U(100, 300),
            # one legal-ladder ISO per batch
            return make_proxy_synth(sample_fn, ori=ori, ratio_range=(100.0, 300.0))
        if name in ("Mix_Dataset", "IMX686_Mix_Dataset"):
            self.synth_keys = self._MIX_KEYS
            hbr_map = None
            if name == "IMX686_Mix_Dataset" and "HB" in command:
                # the LRID bias pastes reach the synth raw: HighBitRecovery
                # runs here, on the card, with the library's ISO-6400 LUT
                # (phone_datasets.py:631). Sony's Mix_Dataset remaps on the
                # host with the nearest-ISO LUT (real_datasets.py:471-473);
                # a second remap here would re-dither with the wrong ISO.
                from pnnp_tpu_torch.physics.hbr import HighBitRecovery

                iso = int(self.dst.get("iso", 6400))
                hbr = HighBitRecovery(camera_type=cam, noise_code=code)
                hbr.get_lut([iso])
                hbr_map = lambda g, x: hbr.map(g, x, iso=iso)
            # the IMX686 Mix loader inherits the paired loader's host-side
            # lr*dgain; Sony's Mix loader leaves it to the synth
            return make_mix_synth(cam, command or "augv5", ori=ori, hbr_map=hbr_map,
                                  host_amplified=name == "IMX686_Mix_Dataset")
        if name in ("SFRN_Dataset", "IMX686_SFRN_Raw_Dataset"):
            # black-frame mode: shot-only synthesis (noise_code + 'b') on the
            # GT plus the real bias-frame read layer, amplified alike
            # (reference: syn_datasets.py:465-579)
            self.synth_keys = ("hr", "lr")
            raw = make_raw_synth(cam, code + "b", ori, clip)

            def synth(generator, batch):
                lr_shot, hr, ratio = raw(generator, batch)
                read_layer = batch["lr"]
                if not ori:
                    read_layer = read_layer * ratio.reshape(-1, 1, 1, 1)
                return lr_shot + read_layer, hr, ratio

            return synth
        # paired data, PMNNP_Dataset and IMX686_PMNNP_Dataset included: the
        # JAX Trainer gives them no synth either (ROADMAP section 3)
        return identity_synth

    # portbench/drivers/train_proxy_synth.py calls the dispatch by this name
    _family_synth = _make_synth

    def _try_restore(self):
        # trainonly is a training mode: resume from 'last' like 'train'
        # (eval modes want the best-PSNR weights: best -> last -> fresh init)
        restored = self.ckpt.restore("last" if self.training else "best")
        if restored is not None:
            self._load_params(restored["params"])
            log(f"Restored checkpoint (epoch {restored['meta'].get('epoch')})")
        else:
            log("No checkpoint found; using fresh init")

    def _recover_state(self):
        """Params from the last checkpoint (fresh init if none) and a fresh
        optimizer, after a step failed part way."""
        self.model.load_state_dict(self._new_model(torch.float32).state_dict())
        restored = self.ckpt.restore("last")
        if restored is not None:
            self._load_params(restored["params"])
            log(f"Recovered params from last checkpoint "
                f"(epoch {restored['meta'].get('epoch')})")
        else:
            log("No checkpoint to recover from; re-initialized fresh params")
        self.opt = make_adam(self.model.parameters())
        self._place_state()

    def _refresh_eval_model(self):
        """Serve the master weights: copy them into the eval model when it is
        a separate (bf16) copy."""
        if self.eval_model is not self.model:
            self.eval_model.load_state_dict(self.model.state_dict())

    def load_torch_checkpoint(self, path: str):
        self._load_params(load_any(path)["params"])
        log(f"Loaded torch checkpoint {path}")

    def _to_device(self, a) -> torch.Tensor:
        """A host array on the device; while tracing is on, counters
        ``h2d.bytes`` and ``h2d.pageable_bytes`` (those not in pinned memory)
        add its bytes."""
        t = torch.from_numpy(np.ascontiguousarray(a))
        if tracing():
            count("h2d.bytes", t.nbytes)
            if not t.is_pinned():
                count("h2d.pageable_bytes", t.nbytes)
        return t.to(self.device)

    def _train_batch(self, batch: dict) -> dict:
        """Host batch -> the tensors its synth reads (``synth_keys``), on the
        device, images NCHW."""
        out = {}
        for k in self.synth_keys:
            if k in batch:
                t = self._to_device(np.asarray(batch[k], np.float32))
                out[k] = t.permute(0, 3, 1, 2).contiguous() if t.dim() == 4 else t
        return out

    # ------------------------------------------------------------------
    def train(self):
        assert self.dataset_train is not None
        bs = int(self.hyper.get("batch_size", 1))
        self._loader_shard = loader_shard(self.mesh, bs)
        loader = DataLoader(
            self.dataset_train, batch_size=bs, shuffle=True,
            num_workers=0 if self.debug else int(self.args.get("num_workers", 2)),
            seed=self.seed, shard=self._loader_shard,
        )
        stop_epoch = int(self.hyper.get("stop_epoch", 100))
        plot_freq = int(self.hyper.get("plot_freq", 50))
        # each data rank synthesizes from its own stream
        gen = torch.Generator(device=self.device).manual_seed(
            rank_seed(self.seed, self.mesh.data_rank))
        self.model.train()

        for epoch in range(self.last_epoch + 1, stop_epoch + 1):
            self.train_psnr.reset()
            self.timer.reset()
            loader.set_epoch(epoch)
            t0 = time.time()
            try:
                for batch in loader:
                    self.timer.tick("loader")
                    with span("h2d", device=True):
                        feed = self._train_batch(self._place_batch(batch))
                    with span("train.step"):
                        metrics = self.train_step(self.model, self.opt, feed, gen, epoch)
                        # the step's one sync, inside 'net': the bucket holds the
                        # device time, and 'loader' only the wait for the host
                        self.train_psnr.update(float(metrics["psnr"]))
                    self.timer.tick("net")
            except RuntimeError as e:
                # Fault tolerance: log and continue with the next epoch (the
                # reference does the same for OOM-class failures,
                # trainer_LRID.py:131-135). The lr is a pure function of the
                # epoch, so skipping a partial epoch is safe; a step that
                # failed part way may have left the params half updated, so
                # they come back from the last checkpoint.
                log(f"Epoch {epoch} aborted by RuntimeError: {e}; recovering state")
                self._recover_state()
            self.train_psnr.record()
            shares = self.timer.shares()
            log(
                f"Epoch {epoch}: loss ok, train_psnr={self.train_psnr.avg:.2f}, "
                f"lr={float(self.lr_schedule(epoch)):.2e}, "
                f"time={time.time() - t0:.1f}s "
                f"[loader {shares.get('loader', 0):.0%} net {shares.get('net', 0):.0%}]"
            )

            eval_psnr = None
            if self.dataset_eval is not None and epoch % plot_freq == 0:
                if hasattr(self.dataset_eval, "fast_eval"):
                    self.dataset_eval.fast_eval(True)
                self.eval(epoch)
                eval_psnr = self.eval_psnr.avg
                if hasattr(self.dataset_eval, "fast_eval"):
                    self.dataset_eval.fast_eval(False)
            is_best = self.ckpt.save(epoch, params_to_jax(self.model.state_dict()),
                                     None, eval_psnr)
            barrier(self.mesh)  # rank 0's files are complete for every reader
            if is_best:
                log(f"Best PSNR is {self.ckpt.best_psnr:.2f} now!!")

            # SGDR period boundary: reload best (reference: trainer_SID.py:169-179);
            # the params change in place, the Adam moments stay
            T = self.hyper.get("T", 1)
            period = max((stop_epoch - self.last_epoch) // max(T, 1), 1)
            if epoch % period == 0 and epoch < stop_epoch:
                restored = self.ckpt.restore("best")
                if restored is not None:
                    self._load_params(restored["params"])
                    log("Period boundary: reloaded best checkpoint")

    def _brightness_correct(self, dst: dict) -> bool:
        # The reference's LRID trainer never calls IlluminanceCorrect in eval
        # (trainer_LRID.py:62 vs :195-319), so IMX686 evals stay uncorrected;
        # only the SID/ELD eval corrects (trainer_SID.py:238). trainer_LED
        # does correct on the same data (trainer_LED.py:122): LEDTrainer sets
        # _phone_eval_corrects.
        if (str(dst.get("dataset", "")).startswith("IMX686")
                and not self._phone_eval_corrects):
            return False
        return bool(self.args.get("brightness_correct", True))

    # ------------------------------------------------------------------
    def eval(self, epoch: int = -1):
        """Eval loop with the reference's metric/log contract
        (trainer_SID.py:181-320), every metric computed on the device: the
        fused step, or the unfused branch (``disable_fused_eval``,
        ``rgb_metrics``, :class:`~pnnp_tpu_torch.trainer_led.LEDTrainer`)."""
        assert self.dataset_eval is not None
        self._refresh_eval_model()
        for m in (self.eval_psnr, self.eval_ssim, self.eval_psnr_lr,
                  self.eval_ssim_lr, self.eval_psnr_dn, self.eval_ssim_dn):
            m.reset()
        metrics_path = f"./metrics/{self.model_name}_metrics.pkl"
        metrics = {}
        main = is_main_process()
        if main and os.path.exists(metrics_path):
            with open(metrics_path, "rb") as f:
                metrics = pickle.load(f)

        correct = self._brightness_correct(self.dst_eval) and epoch < 0
        ori = bool(self.dst_eval.get("ori", self.dst.get("ori", False)))
        fused = self._fused_eval is not None and not self.rgb_metrics
        if self.int8_eval and not (fused and self.fast):
            raise ValueError(
                "--int8 eval serves through the fused raw-domain path: it "
                "requires the fast UNetSeeInDark arch, no "
                "disable_fused_eval, and no rgb_metrics")
        loader = DataLoader(self.dataset_eval, batch_size=1, shuffle=False,
                            num_workers=0 if self.debug else 2)
        for k, batch in enumerate(loader):
            name = batch["name"][0] if isinstance(batch["name"], list) else batch["name"]
            with span("h2d", device=True):
                lr, hr = self._to_device(batch["lr"]), self._to_device(batch["hr"])
            ratio = float(np.asarray(batch["ratio"]).reshape(-1)[0])
            with span("eval.step", device=True):
                if fused:
                    step = ((self._int8_eval_step(lr) or self._fused_eval)
                            if self.int8_eval else self._fused_eval)
                    # a sharded step gathers the corrected frame only for figures
                    kw = {"gather": self.save_plot} if self.mesh_spatial is not None else {}
                    out = step(lr, hr, ratio, ori=ori, correct=correct,
                               with_inputs=self.save_plot, **kw)
                    m = out[1]
                    p, s = float(m["psnr"]), float(m["ssim"])
                    if self.save_plot:
                        p_in, s_in = float(m["psnr_in"]), float(m["ssim_in"])
                        # panels from the step itself (ori-scaled, clipped)
                        dn, lr = (t.reshape(hr.shape) for t in (out[0], out[2]))
                else:
                    dn = self._forward_full(lr)
                    if ori:
                        lr, dn = lr * ratio, dn * ratio
                    lr, dn = lr.clamp(0, 1), dn.clamp(0, 1)
                    if correct:
                        dn = illuminance_correct(dn, hr)
                    tgt255 = hr[0].clamp(0, 1) * 255.0
                    p = float(psnr(dn[0] * 255.0, tgt255))
                    s = float(ssim_kernel(dn[0] * 255.0, tgt255))
                    if self.save_plot and not self.rgb_metrics:
                        p_in = float(psnr(lr[0] * 255.0, tgt255))
                        s_in = float(ssim_kernel(lr[0] * 255.0, tgt255))
            self.eval_psnr.update(p)
            self.eval_ssim.update(s)
            metrics[name] = [p, s]
            if self.save_plot:
                # the reference's active path fills psnrs_lr/psnrs_dn with
                # raw-domain numbers (trainer_SID.py:277,339 + visualization.py:
                # 64-66); rgb_metrics scores them in sRGB through the device ISP
                p_dn, s_dn = p, s
                if self.rgb_metrics:
                    hrc = hr[0].clamp(0, 1)
                    wb, ccm = self._sample_wb_ccm(batch)
                    p_in, s_in = (float(v) for v in rgb_quality(lr[0], hrc, wb, ccm))
                    p_dn, s_dn = (float(v) for v in rgb_quality(dn[0], hrc, wb, ccm))
                    if epoch < 0:
                        metrics[name] = [p_dn, s_dn]
                self.eval_psnr_lr.update(p_in)
                self.eval_ssim_lr.update(s_in)
                self.eval_psnr_dn.update(p_dn)
                self.eval_ssim_dn.update(s_dn)
                if epoch < 0 and main:
                    self._plot_sample(lr[0], dn[0], hr[0], batch, name, epoch)
            log(f"[{k + 1}/{len(loader)}] {name}: PSNR={p:.2f} SSIM={s:.4f}")

        if not self.save_plot:
            self.eval_psnr_dn, self.eval_ssim_dn = self.eval_psnr, self.eval_ssim
        log(
            f"Epoch {epoch}: PSNR={self.eval_psnr.avg:.2f}\n"
            f"psnrs_lr={self.eval_psnr_lr.avg:.2f}, psnrs_dn={self.eval_psnr_dn.avg:.2f}\n"
            f"ssims_lr={self.eval_ssim_lr.avg:.4f}, ssims_dn={self.eval_ssim_dn.avg:.4f}",
            logfile=self.logfile,
        )
        if epoch < 0 and main:
            with open(metrics_path, "wb") as f:
                pickle.dump(metrics, f)
        self._drain_plots()

    def _int8_eval_step(self, lr):
        """The fused eval step served through the W8A8 path (``--int8``),
        or None while the calibration frames accrue: the first
        ``int8_cal_frames`` (N) eval frames of these parameters calibrate
        the scales at pct 99.95 (max-combined), the first N - 1 served by
        the bf16 fused step (their metrics count as the sweep's), and the
        weights are quantized once, at frame N, which serves int8. Cached
        until the served parameters change (``params_key``); an eval shorter
        than N frames runs all in bf16."""
        c = self._int8_cache
        key = params_key(self.eval_model)
        if c["key"] != key:
            c.update(key=key, step=None, cal=[])
        if c["step"] is not None:
            return c["step"]

        import pnnp_tpu_torch.models.unet_s2d_int8 as i8

        x = lr.reshape(1, lr.shape[1], -1, 4) if lr.dim() == 3 else lr
        c["cal"].append(s2d(pad_to_multiple(x, 16)[0].permute(0, 3, 1, 2)))
        if len(c["cal"]) < max(self.int8_cal_frames, 1):
            return None
        tp = self._fused_eval.tparams()
        qp = i8.quantize_params_int8(
            tp, i8.calibrate_act_scales(tp, c["cal"], self.eval_model.dtype, pct=99.95))
        log(f"int8: calibrated on {len(c['cal'])} eval frames (pct 99.95), "
            f"{len(qp['layers'])} layers quantized")
        c["cal"] = []
        c["step"] = self._metrics_step(qp)
        return c["step"]

    @staticmethod
    def _sample_wb_ccm(batch):
        """Per-sample WB gains and CCM of a batch-of-1 eval batch."""
        wb = np.asarray(batch.get("wb", np.array([2.0, 1.0, 1.6, 1.0])), np.float32)
        if wb.ndim > 1:
            wb = wb[0]
        ccm = batch.get("ccm")
        if ccm is not None:
            ccm = np.asarray(ccm, np.float32).reshape(-1, 3, 3)[0]
        return wb, ccm

    def _plot_sample(self, lr, dn, hr, batch, name, epoch):
        """3-panel comparison and the denoised PNG (the reference's contract,
        visualization.py:90-91), ``[h, w, 4]`` panels on the device. The
        device ISP runs inline; the matplotlib figure and the encodes run in
        a 4-thread pool (the reference uses a process pool for the same
        reason, trainer_SID.py:194, 273-279), drained by
        :meth:`_drain_plots`. Without matplotlib nothing is rendered, as in
        JAX, and the skip is logged once per run."""
        if importlib.util.find_spec("matplotlib") is None:
            if not self._figures_skip_logged:
                log("matplotlib is not installed: sample figures skipped")
                self._figures_skip_logged = True
            return
        wb, ccm = self._sample_wb_ccm(batch)
        imgs = [fast_isp(x, wb=wb, ccm=ccm).cpu().numpy() for x in (lr, dn, hr)]
        jpg = os.path.join(self.sample_dir, f"{name}_epoch{epoch}.jpg")
        png = os.path.join(self.sample_dir, f"{name}_denoised.png")
        if self._plot_pool is None:
            from concurrent.futures import ThreadPoolExecutor

            self._plot_pool = ThreadPoolExecutor(max_workers=4,
                                                 thread_name_prefix="figrender")
        self._plot_futures.append(self._plot_pool.submit(_render_sample, imgs, jpg, png))

    def _drain_plots(self):
        """Wait for pending figure renders; a failed render is logged as a
        warning and does not fail the eval."""
        futures, self._plot_futures = self._plot_futures, []
        for f in futures:
            err = f.exception()
            if err is not None:
                log(f"WARNING: figure render failed: {err!r}")

    # ------------------------------------------------------------------
    def test(self, out_dir: Optional[str] = None):
        """Denoise the test split and save outputs as .npy (and, with
        ``save_plot``, the sample figures), the reference's ``test`` mode
        (trainer_SID.py:362-420)."""
        dst = self.dst_test or self.dst_eval
        assert dst is not None, "no dst_test/dst_eval block in runfile"
        dataset = build_dataset(dict(dst, mode="eval"), seed=self.seed)
        self._refresh_eval_model()
        out_dir = out_dir or os.path.join(self.sample_dir, "test")
        os.makedirs(out_dir, exist_ok=True)
        correct = self._brightness_correct(dst)
        ori = bool(dst.get("ori", self.dst.get("ori", False)))

        def dump_split():
            loader = DataLoader(dataset, batch_size=1, shuffle=False,
                                num_workers=0)
            for k, batch in enumerate(loader):
                lr = self._to_device(batch["lr"])
                dn = self._forward_full(lr)
                if ori and "ratio" in batch:  # brighten before clamp
                    r = self._to_device(batch["ratio"]).reshape(-1, 1, 1, 1)
                    lr, dn = lr * r, dn * r
                dn = dn.clamp(0, 1)
                # the reference's output pass corrects against the GT before
                # saving (trainer_SID.py:396-397)
                if correct and "hr" in batch:
                    dn = illuminance_correct(dn, self._to_device(batch["hr"]))
                name = batch["name"][0] if isinstance(batch["name"], list) else str(batch["name"])
                if not is_main_process():
                    continue
                np.save(os.path.join(out_dir, f"{name}_dn.npy"), dn[0].cpu().numpy())
                if self.save_plot:
                    self._plot_sample(lr.clamp(0, 1)[0], dn[0],
                                      self._to_device(batch["hr"])[0], batch, name, -1)
                log(f"[test {k + 1}/{len(loader)}] saved {name}")

        # ratio-split datasets (SID) expose only one split at a time; walk
        # the configured ladder so every frame is dumped
        ratios = [r for r in (dst.get("ratio_list") or []) if r is not None]
        if hasattr(dataset, "change_eval_ratio") and ratios:
            for r in ratios:
                dataset.change_eval_ratio(r)
                dump_split()
        else:
            dump_split()
        self._drain_plots()

    def predict(self, raw_mosaic: np.ndarray, name: str | None = "ds",
                patch_size: int = 512, base: int = 64):
        """Memory-bounded tiled full-frame inference on a black-subtracted
        mosaic ``[H, W]``: packed ``raw + bl`` (normalised by the runfile's
        ``wp``/``bl``), tiles of ``patch_size`` with a ``base/2`` halo, 4
        tiles per forward, the denoised RGBG ``[H/2, W/2, 4]`` returned as
        numpy and saved as ``{name}.npy`` unless ``name`` is None
        (reference: trainer_SID.py:345-360). The mosaic is packed on the
        device (``raw2bayer``, the arithmetic of the JAX package's host
        ``pack_raw_np``)."""
        bl = self.dst.get("bl", 512)
        raw = self._to_device(np.asarray(raw_mosaic, np.float32))
        packed = raw2bayer(raw + bl, self.dst.get("wp", 16383), bl)
        self._refresh_eval_model()
        out = tiled_apply(self.eval_step, packed, patch_size, base, tile_batch=4)
        out = out.cpu().numpy()
        if name and is_main_process():
            np.save(f"{name}.npy", out)
        return out


def eval_sweep(trainer, ds, ratios):
    """Ratio/dgain sweep over an eval dataset, dispatching on its API.

    change_eval_ratio takes precedence (SID ratio splits,
    trainer_SID.py:551-562); ELD-style grids (ratio_list + recheck_length)
    come next."""
    ratios = [r for r in (ratios or []) if r is not None]
    if hasattr(ds, "change_eval_ratio") and ratios:
        for ratio in ratios:
            ds.change_eval_ratio(ratio)
            log(f"Dgain: {ratio}")
            trainer.eval(-1)
    elif hasattr(ds, "ratio_list") and hasattr(ds, "recheck_length") and ratios:
        for dgain in ratios:
            ds.ratio_list = [dgain]
            ds.recheck_length()
            log(f"Dgain: {dgain}")
            trainer.eval(-1)
    else:
        trainer.eval(-1)


def main(argv=None, device=None):
    """CLI entry; runs on ``cuda:<--gpu>`` unless ``device`` names another
    (``device="cpu"`` for a run on the host). Under ``torchrun`` (a
    ``WORLD_SIZE`` above 1) it first joins the process group, each rank on
    ``cuda:<LOCAL_RANK>`` unless ``device`` names one
    (:func:`~pnnp_tpu_torch.parallel.init_distributed`). Returns the
    Trainer."""
    p = Parser.parse(argv)
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world > 1:
        device = init_distributed(device)
    trainer = Trainer(p.runfile, mode=p.mode, nofig=p.nofig, debug=p.debug,
                      int8=p.int8, device=device or f"cuda:{p.gpu}")
    mode = trainer.mode
    if mode in _TRAIN_MODES:
        trainer.train()
        if mode == "train":
            # reference: a finished training run reloads the BEST weights and
            # falls through to the full evaltest sweep (trainer_SID.py:521-534)
            restored = trainer.ckpt.restore("best")
            if restored is not None:
                trainer._load_params(restored["params"])
            mode = "evaltest"
    if mode == "dump":
        # output-saving denoise pass over the test split — the reference's
        # test() METHOD (trainer_SID.py:362-420); distinct from --mode test,
        # which is a metrics sweep
        trainer.test()
    if mode in ("eval", "evaltest", "test"):
        # ELD-style dgain sweep over dst_eval ('eval' / 'evaltest')
        if mode in ("eval", "evaltest") or trainer.dst_test is None:
            eval_sweep(trainer, trainer.dataset_eval,
                       list(trainer.dst_eval.get("ratio_list", [])))
        # 'test' is the dst_test metrics sweep on its own; evaltest runs both
        if trainer.dst_test and (
            mode == "test"
            or (mode == "evaltest" and trainer.dst_test.get("dataset")
                != trainer.dst_eval.get("dataset"))
        ):
            # eval() reads ori/brightness settings from dst_eval, so swap the
            # whole block (not just the dataset) for the test-split sweep
            trainer.dst_eval = dict(trainer.dst_test, mode="evaltest")
            trainer.dataset_eval = build_dataset(trainer.dst_eval, seed=trainer.seed)
            eval_sweep(trainer, trainer.dataset_eval,
                       list(trainer.dst_test.get("ratio_list", [100, 250, 300])))
    return trainer


if __name__ == "__main__":
    main()
