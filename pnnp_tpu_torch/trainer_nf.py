"""Noise-model trainer: NoiseFlow or the ``pw_iso_2stage`` proxy by NLL on
real noise (counterpart of ``pnnp_tpu/trainer_nf.py``; reference:
trainer_NF_SID.py / trainer_NF_LRID.py).

Trains the noise model on real noise residuals of paired data: the NLL of
``(lr - hr) / ratio`` conditioned on ``(hr / ratio, iso)`` (NoiseFlow, its
BatchNorm stats moving in train mode) or at the batch's ISO, masked to dark
pixels (the proxy), then Adam scaled by ``lr(epoch)``; each epoch ends with
the KLD check between sampled and real noise histograms on a fixed held-out
batch (reference: trainer_NF_SID.py:117-123, 163-180) and a checkpoint
scored by it. Same CLI (``python -m pnnp_tpu_torch.trainer_nf -f runfile
--kind {noise_flow,proxy}``), runfiles, log lines and checkpoint files
(NoiseFlow's with its ``batch_stats``) as the JAX trainer; a checkpoint of
either package loads in the other and drives ``NF_Syn_Dataset`` /
``Proxy_Dataset`` training (``proxy_checkpoint``).

Not ported yet: the data-parallel step over several devices (ROADMAP 1.16).
"""

from __future__ import annotations

import argparse
import time
from typing import Optional

import numpy as np
import torch

from pnnp_tpu_torch.config import load_runfile
from pnnp_tpu_torch.data import DataLoader, build_dataset
from pnnp_tpu_torch.models import build_proxy, proxy_to_jax
from pnnp_tpu_torch.ops.kld import kl_div_norm_device
from pnnp_tpu_torch.train import (
    CheckpointManager,
    apply_scaled_updates,
    build_lr_schedule,
    make_adam,
)
from pnnp_tpu_torch.utils.device import resolve_device
from pnnp_tpu_torch.utils.logging import AverageMeter, log

# loaders that emit lr == hr: their noise is synthesized downstream
_SYNTHETIC = ("NF_Syn_Dataset", "Proxy_Dataset", "IMX686_NF_Syn_Dataset",
              "IMX686_Proxy_Dataset")


def make_nf_train_step(nf, lr_schedule, clip_norm: Optional[float] = None):
    """``step(opt, lr_img, hr_img, ratio, iso, epoch) -> metrics`` for the
    NoiseFlow ``nf`` whose parameters ``opt`` holds: the per-dim NLL of
    ``(lr - hr) / ratio`` given ``clean = hr / ratio`` in train mode (the
    couplings' BatchNorm stats move), then Adam scaled by ``lr(epoch)``.
    The gradient uses that NLL; the reported ``nll`` is in the unscaled
    noise domain (``+ mean(log ratio)``, the change of variables, as the
    reference meter trainer_NF_SID.py:131) and ``sd_z`` is scaled by
    ``mean(ratio)``. Images NCHW; ``nll``/``sd_z`` 0-dim tensors, ``lr`` a
    float."""

    def step(opt, lr_img, hr_img, ratio, iso, epoch):
        rb = ratio.reshape(-1, 1, 1, 1)
        opt.zero_grad(set_to_none=True)
        nll, sd_z = nf.loss((lr_img - hr_img) / rb, clean=hr_img / rb, iso=iso, train=True)
        nll.backward()
        lr = float(lr_schedule(epoch))
        apply_scaled_updates(opt, lr, clip_norm)
        return {"nll": nll.detach() + torch.mean(torch.log(ratio)),
                "sd_z": sd_z.detach() * torch.mean(ratio), "lr": lr}

    return step


def make_proxy_train_step(proxy, lr_schedule, dark_thresh: float = 2.0,
                          clip_norm: Optional[float] = None):
    """``step(opt, lr_img, hr_img, ratio, iso, epoch) -> metrics`` for the
    proxy whose parameters ``opt`` (:func:`make_adam`) holds.

    The learned heads model signal-INDEPENDENT dark noise (sampling re-adds
    exact Poisson shot), so on paired data the NLL is masked to pixels whose
    clean signal is below ``dark_thresh`` ADU; dark frames (clean ~ 0) get
    an all-ones mask. ``clip_norm`` clips the gradients' global norm before
    Adam (``hyper.clip_norm``). Images NCHW; metrics ``nll``, ``nll_px``,
    ``nll_row`` as 0-dim tensors, ``lr`` as a float.
    """
    span = proxy.wp - proxy.bl

    def step(opt, lr_img, hr_img, ratio, iso, epoch):
        rb = ratio.reshape(-1, 1, 1, 1)
        noise = (lr_img - hr_img) / rb
        weight = (hr_img / rb * span < dark_thresh).float()
        opt.zero_grad(set_to_none=True)
        nll, aux = proxy.loss(noise, iso, weight=weight)
        nll.backward()
        lr = float(lr_schedule(epoch))
        apply_scaled_updates(opt, lr, clip_norm)
        return {"nll": nll.detach(), "lr": lr, **{k: v.detach() for k, v in aux.items()}}

    return step


class NFTrainer:
    """Noise-model training harness with the reference's last/best + KLD loop."""

    def __init__(self, runfile: str, mode: Optional[str] = None, seed: int = 1997,
                 model_kind: str = "noise_flow", device=None):
        self.args = load_runfile(runfile, mode=mode)
        self.mode = self.args["mode"]
        self.dst = self.args["dst"]
        self.hyper = self.args["hyper"]
        self.model_name = self.args["model_name"]
        self.seed = seed
        self.device = resolve_device(device)
        self.logfile = f"./logs/log_{self.model_name}.log"

        arch = self.args.get("arch", {})
        arch_proxy = self.args.get("arch_proxy", {}) or {}
        # PNNP-style runfiles describe the proxy in `arch_proxy` (the `arch`
        # block is the denoiser); prefer it when training a proxy.
        if "pw_iso" not in arch.get("name", "") and "pw_iso" in arch_proxy.get("name", ""):
            if model_kind == "proxy" or "NoiseFlow" not in arch.get("name", ""):
                arch = arch_proxy
        self.wp = float(self.dst.get("wp", 16383))
        self.bl = float(self.dst.get("bl", 512))
        gen = torch.Generator().manual_seed(seed)
        # opt-in global-norm gradient clipping via hyper.clip_norm
        clip_norm = float(self.hyper["clip_norm"]) if self.hyper.get("clip_norm") else None
        self.lr_schedule = build_lr_schedule(self.hyper)
        if model_kind == "proxy" or "pw_iso" in arch.get("name", ""):
            self.kind = "proxy"
            self.model = build_proxy(dict(arch, name="pw_iso_2stage"), wp=self.wp, bl=self.bl,
                                     generator=gen)
            self.train_step = make_proxy_train_step(
                self.model, self.lr_schedule,
                dark_thresh=float(self.hyper.get("dark_thresh", 2.0)), clip_norm=clip_norm)
        else:
            self.kind = "noise_flow"
            self.model = build_proxy(dict(arch, name="NoiseFlow"), generator=gen)
            self.train_step = make_nf_train_step(self.model, self.lr_schedule, clip_norm)
        self.model.to(self.device)
        self.opt = make_adam(self.model.parameters())
        self.ckpt = CheckpointManager(
            self.args.get("fast_ckpt", "checkpoints"),
            self.args.get("checkpoint", "saved_model"),
            self.model_name, save_freq=self.hyper.get("save_freq", 10),
        )
        self._dataset_train = None
        self.nll_meter = AverageMeter("NLL", ":4f")

    @property
    def dataset_train(self):
        """Built lazily: the model/trainer are usable (sampling, conversion)
        without the training data tree present."""
        if self._dataset_train is None and self.args.get("dst_train"):
            self._dataset_train = build_dataset(self.args["dst_train"], seed=self.seed)
        return self._dataset_train

    @torch.no_grad()
    def sample_noise(self, generator, clean, iso):
        """A noise draw at ``(clean, iso)``; NoiseFlow samples with its
        running BatchNorm stats."""
        return self.model.sample(clean, iso, generator)

    def kld_check(self, generator, lr_img, hr_img, ratio, iso, wp=16383, bl=512):
        """Sampled-vs-real noise histogram KLD (reference: trainer_NF_SID.py:163-180)."""
        rb = ratio.reshape(-1, 1, 1, 1)
        real = lr_img - hr_img  # ADU-normalized residual at eval brightness
        fake = self.sample_noise(generator, hr_img / rb, iso) * rb
        span = wp - bl
        return kl_div_norm_device(real * span, fake * span, bl=bl, wp=wp)

    def _to_device(self, batch):
        """Host batch -> (lr, hr NCHW, ratio [n], iso [n]) on the device."""
        dev = self.device

        def image(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev).permute(0, 3, 1, 2)

        ratio = np.asarray(batch["ratio"], np.float32).reshape(-1)
        if "iso" in batch:
            iso = np.asarray(batch["iso"], np.float32).reshape(-1)
        else:  # datasets without per-item ISO: the dst block's value
            default_iso = float(self.dst.get("iso") or (
                6400.0 if "IMX686" in str(self.dst.get("camera_type")) else 1600.0))
            iso = np.full((ratio.shape[0],), default_iso, np.float32)
        return (image(batch["lr"]), image(batch["hr"]), torch.from_numpy(ratio).to(dev),
                torch.from_numpy(iso).to(dev))

    def train(self):
        assert self.dataset_train is not None
        # Noise-model training needs REAL residuals: the Syn/Proxy loaders
        # emit lr == hr, so (lr - hr) would be identically zero.
        ds_name = self.args.get("dst_train", {}).get("dataset", "")
        if ds_name in _SYNTHETIC:
            raise RuntimeError(
                f"dst_train dataset {ds_name} yields lr == hr; point it at a "
                "paired dataset (SID_Dataset / IMX686_Dataset) or a "
                "bias-frame dataset for noise-model training")
        loader = DataLoader(
            self.dataset_train, batch_size=int(self.hyper.get("batch_size", 1)),
            num_workers=int(self.args.get("num_workers", 2)), seed=self.seed,
        )
        stop_epoch = int(self.hyper.get("stop_epoch", 100))
        gen = torch.Generator(device=self.device).manual_seed(self.seed)

        # Fixed HELD-OUT scoring batch: epoch 0 is never a training epoch, so
        # its first batch is a deterministic sample the per-epoch shuffles
        # never reorder; every checkpoint is scored against the same batch.
        loader.set_epoch(0)
        heldout = self._to_device(next(iter(loader)))

        for epoch in range(1, stop_epoch + 1):
            self.nll_meter.reset()
            loader.set_epoch(epoch)
            t0 = time.time()
            for batch in loader:
                m = self.train_step(self.opt, *self._to_device(batch), epoch)
                self.nll_meter.update(float(m["nll"]))
            log(f"Epoch {epoch}: nll/dim={self.nll_meter.avg:.4f} "
                f"({time.time() - t0:.1f}s)", logfile=self.logfile)
            # score EVERY saved checkpoint: `best` is never written (or
            # skipped) on an unscored epoch
            kld = self.kld_check(gen, *heldout, wp=self.wp, bl=self.bl)
            if epoch % int(self.hyper.get("plot_freq", 10)) == 0:
                log(f"Epoch {epoch}: KLD fwd={float(kld['kl_fwd']):.4f} "
                    f"inv={float(kld['kl_inv']):.4f} sym={float(kld['kl_sym']):.4f}",
                    logfile=self.logfile)
            self.ckpt.save(epoch, *proxy_to_jax(self.model), eval_psnr=-float(kld["kl_sym"]))


def main(argv=None, device=None):
    """CLI entry; runs on the card unless ``device`` names another
    (``device="cpu"`` for a run on the host). Returns the NFTrainer."""
    p = argparse.ArgumentParser()
    p.add_argument("--runfile", "-f", required=True)
    p.add_argument("--mode", "-m", default="train")
    p.add_argument("--kind", default="noise_flow", choices=["noise_flow", "proxy"])
    a = p.parse_args(argv)
    trainer = NFTrainer(a.runfile, mode=a.mode, model_kind=a.kind, device=device)
    trainer.train()
    return trainer


if __name__ == "__main__":
    main()
