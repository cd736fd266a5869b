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

Several ranks (``torchrun --nproc_per_node=N -m pnnp_tpu_torch.trainer_nf
...``) train data-parallel, as ``pnnp_tpu/trainer_nf.py:163-171``: each
rank loads its block of every batch, the batch statistics (NoiseFlow's
BatchNorm moments, the proxy's masked-mean denominators) are the global
batch's, the gradients are averaged before the clip and Adam, and rank 0
logs and writes the checkpoints. Every rank scores the whole held-out batch.
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Optional

import numpy as np
import torch

from pnnp_tpu_torch.config import load_runfile
from pnnp_tpu_torch.data import DataLoader, build_dataset
from pnnp_tpu_torch.kernels import proxy_core
from pnnp_tpu_torch.models import build_proxy, proxy_to_jax
from pnnp_tpu_torch.ops.kld import kl_div_norm_device
from pnnp_tpu_torch.parallel import (
    barrier,
    init_distributed,
    loader_shard,
    make_mesh,
    make_sharded_noise_step,
    replicate,
    shard_batch,
)
from pnnp_tpu_torch.train import (
    CheckpointManager,
    apply_scaled_updates,
    build_lr_schedule,
    make_adam,
)
from pnnp_tpu_torch.utils.device import resolve_device
from pnnp_tpu_torch.utils.logging import AverageMeter, is_main_process, log
from pnnp_tpu_torch.utils.profiling import count, span

# loaders that emit lr == hr: their noise is synthesized downstream
_SYNTHETIC = ("NF_Syn_Dataset", "Proxy_Dataset", "IMX686_NF_Syn_Dataset",
              "IMX686_Proxy_Dataset")


class NoiseStep:
    """``step(opt, lr_img, hr_img, ratio, iso, epoch) -> metrics`` of a noise
    model: ``loss_fn(lr_img, hr_img, ratio, iso) -> (loss, metrics)``, then
    the optional global-norm clip (``clip_norm``) and Adam scaled by
    ``lr(epoch)``. The stages are methods (:meth:`forward_backward`,
    :meth:`update`) so that the data-parallel step
    (:func:`~pnnp_tpu_torch.parallel.make_sharded_noise_step`) averages the
    gradients between them, before the clip. Metrics are detached 0-dim
    tensors, ``lr`` a float. While tracing is on, the loss and its backward
    are device spans ``<kind>.forward`` and ``<kind>.backward``.

    A step whose ``loss_fn`` is ``capturable`` (one that syncs nothing with
    the host and reads no tensor's value on it) replays its forward and its
    backward as two CUDA graphs (:class:`_StepGraphs`) where it can: float32
    CUDA inputs that do not require grad, float32 parameters on their
    device, and a model whose masked means are its own (``data_mean`` unset:
    one data rank). The first call at an input key (shapes, dtypes, device,
    parameters) runs eagerly as the warm-up, the second captures the graphs
    and replays them, and every later call replays them; anything else runs
    eagerly. The counters ``<kind>.graph_captures``, ``<kind>.graph_replays``
    and ``<kind>.graph_eager`` count them. Adam stays eager."""

    def __init__(self, model, loss_fn, lr_schedule, clip_norm: Optional[float] = None,
                 kind: str = "proxy", capturable: bool = False):
        self.model, self.loss_fn = model, loss_fn
        self.lr_schedule, self.clip_norm = lr_schedule, clip_norm
        self.kind, self.capturable = kind, capturable
        self.spans = (f"{kind}.forward", f"{kind}.backward")
        self._graphs: dict = {}   # input key -> _StepGraphs, or None after the warm-up

    def forward_backward(self, opt, lr_img, hr_img, ratio, iso) -> dict:
        opt.zero_grad(set_to_none=True)
        inputs = (lr_img, hr_img, ratio, iso)
        graphs = self._graphed(inputs)
        if graphs is None:
            count(f"{self.kind}.graph_eager")
            with span(self.spans[0], device=True):
                loss, metrics = self.loss_fn(*inputs)
            # the proxy's backward recomputes each checkpointed chunk of its density
            with span(self.spans[1], device=True):
                loss.backward()
            return {k: v.detach() for k, v in metrics.items()}
        count(f"{self.kind}.graph_replays")
        with span(self.spans[0], device=True):
            graphs.forward(inputs)
        with span(self.spans[1], device=True):
            graphs.backward()
        return graphs.metrics()

    def _graphed(self, inputs):
        """The graphs that replay this call, captured here at the second
        call at its key; ``None`` where the call runs eagerly."""
        if not (self.capturable and getattr(self.model, "data_mean", None) is None
                and _graph_inputs(inputs)):
            return None
        params = list(self.model.parameters())
        key = (tuple((t.shape, t.dtype) for t in inputs), inputs[0].device,
               tuple(p.data_ptr() for p in params))
        if key not in self._graphs:
            self._graphs[key] = None  # this call is the warm-up
            return None
        if self._graphs[key] is None:
            if not all(p.dtype == torch.float32 and p.device == inputs[0].device
                       for p in params):
                return None
            self._graphs[key] = _StepGraphs(self.model, self.loss_fn, inputs)
            count(f"{self.kind}.graph_captures")
        return self._graphs[key]

    def update(self, opt, epoch) -> float:
        lr = float(self.lr_schedule(epoch))
        apply_scaled_updates(opt, lr, self.clip_norm)
        return lr

    def __call__(self, opt, lr_img, hr_img, ratio, iso, epoch) -> dict:
        metrics = self.forward_backward(opt, lr_img, hr_img, ratio, iso)
        return {**metrics, "lr": self.update(opt, epoch)}


def _graph_inputs(inputs) -> bool:
    """The inputs a graph takes: float32 tensors on one CUDA device that do
    not require grad."""
    dev = getattr(inputs[0], "device", None)
    return all(isinstance(t, torch.Tensor) and t.is_cuda and t.device == dev
               and t.dtype == torch.float32 and not t.requires_grad for t in inputs)


class _StepGraphs:
    """A :class:`NoiseStep`'s forward and backward at one input key as two
    CUDA graphs, laid out as ``torch.cuda.make_graphed_callables`` lays
    them out: static inputs that each call copies its inputs into, the loss
    and metrics that the forward graph writes, the gradients that the
    backward graph writes (left in ``p.grad``, where Adam reads them), both
    in one memory pool. Capturing runs nothing: the first replay does the
    capturing call's arithmetic. The fused proxy kernels' launches that
    each graph holds count at each of its replays."""

    def __init__(self, model, loss_fn, inputs):
        self.inputs = [torch.empty(t.shape, dtype=t.dtype, device=t.device) for t in inputs]
        self.fwd, self.bwd = torch.cuda.CUDAGraph(), torch.cuda.CUDAGraph()
        # thread_local: the loader's worker threads may use CUDA meanwhile
        with proxy_core.holding() as self.fwd_held, \
                torch.cuda.graph(self.fwd, capture_error_mode="thread_local"):
            loss, metrics = loss_fn(*self.inputs)
        # the grads are unset (zero_grad(set_to_none=True)), so the backward
        # writes fresh ones, as the eager step's does
        with proxy_core.holding() as self.bwd_held, \
                torch.cuda.graph(self.bwd, pool=self.fwd.pool(),
                                 capture_error_mode="thread_local"):
            loss.backward()
        self.out = {k: v.detach() for k, v in metrics.items()}
        self.grads = [(p, p.grad) for p in model.parameters() if p.grad is not None]

    def forward(self, inputs) -> None:
        for static, t in zip(self.inputs, inputs):
            static.copy_(t)
        self.fwd.replay()
        proxy_core.replayed(self.fwd_held)

    def backward(self) -> None:
        self.bwd.replay()
        proxy_core.replayed(self.bwd_held)
        for p, g in self.grads:
            p.grad = g

    def metrics(self) -> dict:
        """The replay's metrics, copied: the next replay overwrites the
        graph's own."""
        return {k: v.clone() for k, v in self.out.items()}


def make_nf_train_step(nf, lr_schedule, clip_norm: Optional[float] = None) -> NoiseStep:
    """The :class:`NoiseStep` of the NoiseFlow ``nf`` whose parameters the
    step's ``opt`` holds: the per-dim NLL of ``(lr - hr) / ratio`` given
    ``clean = hr / ratio`` in train mode (the couplings' BatchNorm stats
    move). The gradient uses that NLL; the reported ``nll`` is in the
    unscaled noise domain (``+ mean(log ratio)``, the change of variables,
    as the reference meter trainer_NF_SID.py:131) and ``sd_z`` is scaled by
    ``mean(ratio)``. Images NCHW."""

    def loss_fn(lr_img, hr_img, ratio, iso):
        rb = ratio.reshape(-1, 1, 1, 1)
        nll, sd_z = nf.loss((lr_img - hr_img) / rb, clean=hr_img / rb, iso=iso, train=True)
        return nll, {"nll": nll + torch.mean(torch.log(ratio)),
                     "sd_z": sd_z * torch.mean(ratio)}

    return NoiseStep(nf, loss_fn, lr_schedule, clip_norm, kind="nf")


def make_proxy_train_step(proxy, lr_schedule, dark_thresh: float = 2.0,
                          clip_norm: Optional[float] = None) -> NoiseStep:
    """The :class:`NoiseStep` of the proxy whose parameters the step's
    ``opt`` (:func:`make_adam`) holds.

    The learned heads model signal-INDEPENDENT dark noise (sampling re-adds
    exact Poisson shot), so on paired data the NLL is masked to pixels whose
    clean signal is below ``dark_thresh`` ADU; dark frames (clean ~ 0) get
    an all-ones mask. ``clip_norm`` clips the gradients' global norm before
    Adam (``hyper.clip_norm``). Images NCHW; metrics ``nll``, ``nll_px``,
    ``nll_row``. The loss is capturable into a CUDA graph unless the proxy
    adds its ISO-curvature penalty, whose ISO grid is a copy from the host.
    """
    span = proxy.wp - proxy.bl

    def loss_fn(lr_img, hr_img, ratio, iso):
        rb = ratio.reshape(-1, 1, 1, 1)
        noise = (lr_img - hr_img) / rb
        weight = (hr_img / rb * span < dark_thresh).float()
        nll, aux = proxy.loss(noise, iso, weight=weight)
        return nll, {"nll": nll, **aux}

    return NoiseStep(proxy, loss_fn, lr_schedule, clip_norm,
                     capturable=proxy.smooth_iso_w == 0)


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
        # data parallel over every rank of the process group (one rank: the
        # 1 x 1 mesh, the step itself)
        self.mesh = make_mesh()
        replicate(self.mesh, self.model)
        self._base_train_step = self.train_step  # unsharded (parity tests)
        self.train_step = make_sharded_noise_step(self.mesh, self.train_step)
        self.ckpt = CheckpointManager(
            self.args.get("fast_ckpt", "checkpoints"),
            self.args.get("checkpoint", "saved_model"),
            self.model_name, save_freq=self.hyper.get("save_freq", 10),
            writer=is_main_process(),
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
        bs = int(self.hyper.get("batch_size", 1))
        workers = int(self.args.get("num_workers", 2))
        shard = loader_shard(self.mesh, bs)
        loader = DataLoader(self.dataset_train, batch_size=bs, num_workers=workers,
                            seed=self.seed, shard=shard)
        stop_epoch = int(self.hyper.get("stop_epoch", 100))
        gen = torch.Generator(device=self.device).manual_seed(self.seed)

        # Fixed HELD-OUT scoring batch: epoch 0 is never a training epoch, so
        # its first batch is a deterministic sample the per-epoch shuffles
        # never reorder; every checkpoint is scored against the same batch,
        # the whole of it on every rank.
        whole = DataLoader(self.dataset_train, batch_size=bs, num_workers=workers,
                           seed=self.seed)
        whole.set_epoch(0)
        heldout = self._to_device(next(iter(whole)))

        def local(batch):
            """This rank's rows (the loader's block, or JAX's shard_batch rule)."""
            t = self._to_device(batch)
            return t if shard is not None else shard_batch(self.mesh, t, t[2].shape[0])

        for epoch in range(1, stop_epoch + 1):
            self.nll_meter.reset()
            loader.set_epoch(epoch)
            t0 = time.time()
            for batch in loader:
                m = self.train_step(self.opt, *local(batch), epoch)
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
            barrier(self.mesh)


def main(argv=None, device=None):
    """CLI entry; runs on the card unless ``device`` names another
    (``device="cpu"`` for a run on the host). Under ``torchrun`` it first
    joins the process group, each rank on ``cuda:<LOCAL_RANK>`` unless
    ``device`` names one. Returns the NFTrainer."""
    p = argparse.ArgumentParser()
    p.add_argument("--runfile", "-f", required=True)
    p.add_argument("--mode", "-m", default="train")
    p.add_argument("--kind", default="noise_flow", choices=["noise_flow", "proxy"])
    a = p.parse_args(argv)
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        device = init_distributed(device)
    trainer = NFTrainer(a.runfile, mode=a.mode, model_kind=a.kind, device=device)
    trainer.train()
    return trainer


if __name__ == "__main__":
    main()
