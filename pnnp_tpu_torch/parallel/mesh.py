"""Several devices through ``torch.distributed`` (counterpart of
``pnnp_tpu/parallel/mesh.py``, function by function).

The JAX package runs SPMD over a ``jax.sharding.Mesh`` of two axes: ``data``
(batch sharding for training, gradients psum'ed by XLA) and ``spatial``
(width sharding of the full-frame eval, halos exchanged by ``ppermute``).
Here every device is one process (a rank) and the two axes are process
groups: rank ``r`` sits at ``(r // n_spatial, r % n_spatial)``, JAX's
``devices.reshape(n_data, n_spatial)``. A world of one rank, or no process
group at all, is the 1 x 1 mesh, and every wrapper below is then the
single-device call.

What JAX's partitioner does implicitly is explicit here:

* the data-parallel steps average the gradients over the data group (one
  flat bucket, one ``all_reduce``) before the optimizer, so that clipping
  sees the averaged gradient, and all-reduce the logged metrics; the noise
  models' batch statistics (NoiseFlow's BatchNorm moments, the proxy's
  masked-mean denominators) are reduced over the group with a gradient,
  which is what flax computes over the global batch under SPMD jit;
* the spatial wrappers take the whole frame on every rank (each rank of the
  spatial group loads it), keep this rank's columns, exchange the halos
  with the ring neighbours, and gather the output columns back.

The collectives are ``all_reduce``, ``broadcast`` and ``all_gather`` only:
``gloo`` takes CUDA tensors for these three, but point-to-point
``send``/``recv`` only on the host. So the ring ``ppermute`` is an
``all_gather`` of the edge columns from which each rank picks its
neighbours' (:func:`_ring`), on every backend; with two ranks per spatial
group that moves what a pair of ``ppermute`` would. The one place where
the backend decides is :func:`_backend_device`: ``nccl`` takes only CUDA
tensors, so host tensors (the optimizer's step counts) are staged through
the card there.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from pnnp_tpu_torch.kernels.ssim import ssim_flat_sum
from pnnp_tpu_torch.models.unet_s2d import d2s, s2d
from pnnp_tpu_torch.ops.metrics import ssim_sum as ssim_sum_plain
from pnnp_tpu_torch.train.steps import make_eval_metrics_step, pad_split, refuse_packed_frame


@dataclass
class Mesh:
    """A ``(data, spatial)`` grid of ranks and the process groups of its two
    axes. ``data_group`` holds the ranks of this rank's column (same spatial
    coordinate), ``spatial_group`` those of its row; a group of one rank is
    ``None`` and takes no collective."""

    n_data: int = 1
    n_spatial: int = 1
    rank: int = 0
    data_group: Any = None
    spatial_group: Any = None
    backend: Optional[str] = None

    @property
    def shape(self) -> dict:
        return {"data": self.n_data, "spatial": self.n_spatial}

    @property
    def size(self) -> int:
        return self.n_data * self.n_spatial

    @property
    def data_rank(self) -> int:
        return self.rank // self.n_spatial

    @property
    def spatial_rank(self) -> int:
        return self.rank % self.n_spatial


def make_mesh(n_data: Optional[int] = None, n_spatial: int = 1) -> Mesh:
    """The mesh over the default process group's ranks (``n_data`` defaults
    to ``world // n_spatial``). Every rank builds every group, in one order,
    as ``new_group`` requires; no group is made later."""
    if not (dist.is_available() and dist.is_initialized()):
        world, rank, backend = 1, 0, None
    else:
        world, rank, backend = dist.get_world_size(), dist.get_rank(), dist.get_backend()
    if n_data is None:
        n_data = max(world // n_spatial, 1)
    if n_data * n_spatial != world:
        raise ValueError(f"a {n_data} x {n_spatial} mesh does not cover the "
                         f"{world} rank(s) of the process group")
    if world == 1:
        return Mesh()
    mesh = Mesh(n_data=n_data, n_spatial=n_spatial, rank=rank, backend=backend)
    if n_data > 1:  # the data groups: one per spatial coordinate (a column)
        for s in range(n_spatial):
            g = dist.new_group([d * n_spatial + s for d in range(n_data)])
            if s == mesh.spatial_rank:
                mesh.data_group = g
    if n_spatial > 1:  # the spatial groups: one per data coordinate (a row)
        for d in range(n_data):
            g = dist.new_group([d * n_spatial + s for s in range(n_spatial)])
            if d == mesh.data_rank:
                mesh.spatial_group = g
    return mesh


def init_distributed(device=None) -> torch.device:
    """The process group of a multi-rank launch, from the environment that
    ``torchrun`` sets (``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``,
    ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR``/``MASTER_PORT``), once; returns
    this rank's device: ``device`` when the caller names one, else
    ``cuda:<LOCAL_RANK>`` (wrapped onto the cards there are). The backend
    is ``nccl`` where each local rank has a card of its own, ``gloo``
    otherwise (NCCL refuses two ranks on one card). A world of one rank, or
    a group already initialized by the caller, is left as it is."""
    from pnnp_tpu_torch.utils.device import resolve_device

    world = int(os.environ.get("WORLD_SIZE", "1"))
    local = int(os.environ.get("LOCAL_RANK", "0"))
    if device is None and world > 1 and torch.cuda.is_available():
        device = f"cuda:{local % torch.cuda.device_count()}"
    dev = resolve_device(device)
    if world > 1 and not dist.is_initialized():
        local_world = int(os.environ.get("LOCAL_WORLD_SIZE", str(world)))
        own_card = dev.type == "cuda" and torch.cuda.device_count() >= local_world
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group("nccl" if own_card else "gloo", init_method="env://")
    return dev


def barrier(mesh: Mesh) -> None:
    """Wait for every rank of the mesh (after rank 0 wrote a file the
    others read)."""
    if mesh.size > 1:
        dist.barrier()


def rank_seed(seed: int, rank: int) -> int:
    """The seed of data rank ``rank``'s random stream: ``seed`` itself on
    rank 0 (a one-rank run draws what it drew before), an independent
    stream of ``(seed, rank)`` on the others."""
    if rank == 0:
        return seed
    return int(np.random.SeedSequence([seed, rank]).generate_state(1)[0])


# ---------------------------------------------------------------------------
# Collectives
# ---------------------------------------------------------------------------


def _backend_device(mesh: Mesh, t: torch.Tensor) -> torch.device:
    """Where a collective of ``mesh`` takes ``t``: ``nccl`` only on the
    card, ``gloo`` on the host and the card alike."""
    if mesh.backend == "nccl" and not t.is_cuda:
        return torch.device("cuda", torch.cuda.current_device())
    return t.device


def _flat_collective(mesh: Mesh, tensors: list, op) -> None:
    """``op(flat)`` on one flat bucket of ``tensors`` per dtype and device,
    then copied back in place (whatever their memory format)."""
    buckets: dict = {}
    for t in tensors:
        buckets.setdefault((t.dtype, t.device), []).append(t)
    for group in buckets.values():
        flat = torch.cat([t.reshape(-1) for t in group])
        dev = _backend_device(mesh, flat)
        flat = op(flat.to(dev)).to(group[0].device)
        offset = 0
        for t in group:
            t.copy_(flat[offset:offset + t.numel()].view(t.shape))
            offset += t.numel()


def average_gradients(mesh: Mesh, params) -> None:
    """Each gradient becomes its mean over the data group (one bucket)."""
    if mesh.n_data == 1:
        return
    grads = [p.grad for p in params if p.grad is not None]

    def mean(flat):
        dist.all_reduce(flat, group=mesh.data_group)
        return flat.div_(mesh.n_data)

    with torch.no_grad():
        _flat_collective(mesh, grads, mean)


def data_mean(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """The mean of ``t`` over the data group, without gradient."""
    if mesh.n_data == 1:
        return t
    t = t.detach().clone()
    dist.all_reduce(t, group=mesh.data_group)
    return t / mesh.n_data


def spatial_sum(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """The sum of ``t`` over the spatial group."""
    if mesh.n_spatial == 1:
        return t
    t = t.clone()
    dist.all_reduce(t, group=mesh.spatial_group)
    return t


class _AllReduceMean(torch.autograd.Function):
    """Mean over a group whose gradient is the mean of the ranks' incoming
    gradients: with the gradients averaged afterwards, each rank's
    parameters see the derivative of the global objective."""

    @staticmethod
    def forward(ctx, t, group, n):
        ctx.group, ctx.n = group, n
        t = t.clone()
        dist.all_reduce(t, group=group)
        return t / n

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad / ctx.n, None, None


def _gather(mesh: Mesh, t: torch.Tensor) -> list:
    """``t`` of every rank of the spatial group, in spatial order."""
    out = [torch.empty_like(t) for _ in range(mesh.n_spatial)]
    dist.all_gather(out, t.contiguous(), group=mesh.spatial_group)
    return out


def _ring(mesh: Mesh, t: torch.Tensor):
    """``(t of the left neighbour, t of the right neighbour)`` on the spatial
    ring (the first and last ranks are each other's neighbours): what the
    two ring ``ppermute`` deliver, as one ``all_gather``."""
    got = _gather(mesh, t)
    i, n = mesh.spatial_rank, mesh.n_spatial
    return got[(i - 1) % n], got[(i + 1) % n]


def _gather_columns(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """This rank's columns ``[n, H, w, C]`` -> the whole width, on every rank."""
    return torch.cat(_gather(mesh, t), dim=2)


# ---------------------------------------------------------------------------
# Data parallel
# ---------------------------------------------------------------------------


def _leaves_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _leaves_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_leaves_map(fn, v) for v in tree)
    return fn(tree)


def shard_batch(mesh: Mesh, batch, batch_dim_size: Optional[int] = None):
    """This rank's contiguous block of every batch-major leaf (JAX's
    ``P("data")`` block order: data rank ``r`` of ``n`` keeps rows
    ``r*b/n .. (r+1)*b/n``). ``batch_dim_size``: when given, only leaves
    whose dim 0 equals it are sharded; leaves whose dim 0 is not divisible
    by the axis (odd-collated metadata such as a ccm) stay whole. Works on
    numpy arrays and tensors alike."""
    n, r = mesh.n_data, mesh.data_rank

    def put(x):
        shape = getattr(x, "shape", ())
        if n == 1 or len(shape) < 1 or shape[0] % n:
            return x
        if batch_dim_size is not None and shape[0] != batch_dim_size:
            return x
        k = shape[0] // n
        return x[r * k:(r + 1) * k]

    return _leaves_map(put, batch)


def loader_shard(mesh: Mesh, batch_size: int) -> Optional[tuple]:
    """``(data rank, n_data)`` for the host loader when each data rank can
    load its own block of a global batch's items (``batch_size`` divisible
    by ``n_data``), else ``None``: every rank then loads the whole batch
    and :func:`place_batch` keeps its rows."""
    if mesh.n_data > 1 and batch_size % mesh.n_data == 0:
        return mesh.data_rank, mesh.n_data
    return None


def place_batch(mesh: Mesh, batch: dict) -> dict:
    """A whole host batch -> this data rank's rows: a batch whose row count
    is not a multiple of ``n_data`` is wrap-padded first (as
    ``DataParallel`` scatters an uneven batch), then :func:`shard_batch`
    keeps the rank's block (``pnnp_tpu/trainer.py:429-442``)."""
    if mesh.n_data <= 1:
        return batch
    n = len(batch.get("hr", next(iter(batch.values()))))
    pad = (-n) % mesh.n_data
    if pad:
        idx = np.arange(n + pad) % n
        batch = {k: (np.asarray(v)[idx] if np.asarray(v).shape[:1] == (n,) else v)
                 for k, v in batch.items()}
    return shard_batch(mesh, batch, batch_dim_size=n + pad)


def _state_tensors(obj) -> list:
    if isinstance(obj, torch.nn.Module):
        return [t.data for t in obj.parameters()] + list(obj.buffers())
    if isinstance(obj, torch.optim.Optimizer):
        return [v for s in obj.state.values() for v in s.values()
                if isinstance(v, torch.Tensor)]
    if isinstance(obj, torch.Tensor):
        return [obj.data]
    if isinstance(obj, (list, tuple)):
        return [t for o in obj for t in _state_tensors(o)]
    return []


def replicate(mesh: Mesh, tree):
    """Parameters, buffers and optimizer state of ``tree`` (a module, an
    optimizer, a tensor or a list of them) broadcast from rank 0 of the
    mesh to every rank, in place; returns ``tree``."""
    if mesh.size == 1:
        return tree

    def bcast(flat):
        dist.broadcast(flat, src=0)
        return flat

    with torch.no_grad():
        _flat_collective(mesh, _state_tensors(tree), bcast)
    return tree


class ShardedTrainStep:
    """The data-parallel :class:`~pnnp_tpu_torch.train.steps.TrainStep`:
    ``step(model, opt, batch, generator, epoch)`` on this rank's block of
    the global batch (:func:`shard_batch`). The synth draws from this
    rank's generator; the gradients are averaged over the data group before
    Adam; ``loss`` is the mean of the ranks' (equal blocks: the global
    batch's mean) and ``psnr`` comes from the global mean squared error."""

    def __init__(self, mesh: Mesh, step):
        self.mesh, self.step = mesh, step

    def __call__(self, model, opt, batch, generator, epoch) -> dict:
        st = self.step
        lr_img, hr_img = st.make_pair(batch, generator)
        loss, pred = st.forward_backward(model, lr_img, hr_img)
        average_gradients(self.mesh, model.parameters())
        lr = st.update(opt, epoch)
        return st.metrics(loss, pred, hr_img, lr,
                          reduce=lambda t: data_mean(self.mesh, t))


def make_sharded_train_step(mesh: Mesh, train_step):
    """The data-parallel train step over ``mesh``'s data axis (the step
    itself on a mesh of one data rank)."""
    return train_step if mesh.n_data == 1 else ShardedTrainStep(mesh, train_step)


def bind_data_group(mesh: Mesh, model) -> None:
    """Give every submodule of ``model`` with a ``data_mean`` hook (the
    flows' BatchNorm, the proxy's masked means) the data group's mean, with
    gradient; ``None`` on a mesh of one data rank."""
    fn = None
    if mesh.n_data > 1:
        fn = lambda t: _AllReduceMean.apply(t, mesh.data_group, mesh.n_data)
    for m in model.modules():
        if hasattr(type(m), "data_mean"):
            m.data_mean = fn


class ShardedNoiseStep:
    """The data-parallel noise-model step (``trainer_nf``):
    ``step(opt, lr_img, hr_img, ratio, iso, epoch)`` on this rank's block.
    The model's batch statistics are the data group's
    (:func:`bind_data_group`), the gradients are averaged before the
    optional clip and Adam, and the metrics are the group's means."""

    def __init__(self, mesh: Mesh, step):
        self.mesh, self.step = mesh, step
        bind_data_group(mesh, step.model)

    def __call__(self, opt, lr_img, hr_img, ratio, iso, epoch) -> dict:
        st = self.step
        m = st.forward_backward(opt, lr_img, hr_img, ratio, iso)
        average_gradients(self.mesh, (p for g in opt.param_groups for p in g["params"]))
        lr = st.update(opt, epoch)
        keys = sorted(m)
        vals = data_mean(self.mesh, torch.stack([m[k].float() for k in keys]))
        return {**dict(zip(keys, vals)), "lr": lr}


def make_sharded_noise_step(mesh: Mesh, step):
    """The data-parallel wrapper of a ``trainer_nf`` step (the step itself
    on a mesh of one data rank)."""
    return step if mesh.n_data == 1 else ShardedNoiseStep(mesh, step)


# ---------------------------------------------------------------------------
# Width-sharded eval
# ---------------------------------------------------------------------------


def _halo_slab(mesh: Mesh, x: torch.Tensor, halo: int) -> torch.Tensor:
    """This rank's columns ``[n, H, w, C]`` with ``halo`` columns on each
    side: the ring neighbours' edges, or at the frame's two ends the shard's
    own border reflected without the edge column (``mode="reflect"``)."""
    i, nsp = mesh.spatial_rank, mesh.n_spatial
    edges = torch.stack([x[:, :, :halo], x[:, :, -halo:]])
    from_left, from_right = _ring(mesh, edges)
    left = x[:, :, 1:halo + 1].flip(2) if i == 0 else from_left[1]
    right = x[:, :, -halo - 1:-1].flip(2) if i == nsp - 1 else from_right[0]
    return torch.cat([left, x, right], dim=2)


def spatial_eval(mesh: Mesh, apply_fn, image: torch.Tensor, halo: int = 32):
    """Full-frame eval with the width split over the spatial group: each
    rank takes its ``W / nsp`` columns of ``image`` ``[n, H, W, C]`` (the
    whole frame, on every rank), adds ``halo`` columns from its ring
    neighbours (:func:`_halo_slab`), runs ``apply_fn`` (``[n, H, w, C]`` ->
    the same shape), drops the halo and gathers the columns: the output
    frame, on every rank. ``halo == 0`` runs each shard alone."""
    nsp = mesh.n_spatial
    if nsp == 1:
        return apply_fn(image)
    w = image.shape[2] // nsp
    i = mesh.spatial_rank
    x = image[:, :, i * w:(i + 1) * w]
    if halo == 0:
        return _gather_columns(mesh, apply_fn(x))
    out = apply_fn(_halo_slab(mesh, x, halo))
    return _gather_columns(mesh, out[:, :, halo:-halo])


def spatial_eval_auto(mesh: Mesh, apply_fn, image: torch.Tensor,
                      halo: int = 96, align: int = 16):
    """:func:`spatial_eval` for any frame: reflect-pads H to ``%align`` and W
    to ``%(nsp * align)`` (split as :func:`~pnnp_tpu_torch.train.steps.pad_split`
    splits it), runs the sharded eval and crops back. A frame too narrow to
    shard (local width <= ``halo``) takes ``apply_fn`` whole."""
    nsp = mesh.n_spatial
    if nsp == 1:
        return apply_fn(image)
    H, W = int(image.shape[1]), int(image.shape[2])
    Hp = -(-H // align) * align
    Wp = -(-W // (nsp * align)) * (nsp * align)
    if Wp // nsp <= halo or Wp - W >= W or Hp - H >= H:
        return apply_fn(image)
    pt, pl = (Hp - H) // 2, (Wp - W) // 2
    img = image
    if Hp != H or Wp != W:
        img = F.pad(image.permute(0, 3, 1, 2), (pl, Wp - W - pl, pt, Hp - H - pt),
                    mode="reflect").permute(0, 2, 3, 1)
    out = spatial_eval(mesh, apply_fn, img, halo=halo)
    return out[:, pt:pt + H, pl:pl + W, :]


def _reflect_pad_nhwc(x: torch.Tensor, pt, pb, pl, pr) -> torch.Tensor:
    if not (pt or pb or pl or pr):
        return x
    return F.pad(x.permute(0, 3, 1, 2), (pl, pr, pt, pb), mode="reflect").permute(0, 2, 3, 1)


def make_eval_metrics_step_sharded(model, mesh: Mesh, halo: int = 96,
                                   qparams: Optional[dict] = None):
    """Width-sharded fused full-frame eval over the mesh's spatial group:
    forward, clip, illuminance correction, PSNR and SSIM, with the contract
    of :func:`~pnnp_tpu_torch.train.steps.make_eval_metrics_step`
    (``step(lr, hr, ratio, *, ori, correct, with_inputs)`` ->
    the corrected flat frame ``[1, H, W*4]``, the metrics and, with
    ``with_inputs``, the input panel; the same on every rank).

    Every rank takes the whole frame and keeps its ``wloc`` columns of the
    padded frame (H to ``%16``, W to ``%(16*nsp)``, split as ``pad_split``);
    per stage:

    * forward: ``halo`` columns from the ring neighbours (reflected at the
      frame's ends), then this rank's forward on ``[1, 4, Hp, wloc+2*halo]``
      (the module in its dtype and memory format, or under ``qparams`` the
      W8A8 packed forward), cropped;
    * correction: the num/den sums over valid columns all-reduced before
      the one global scale;
    * PSNR: the masked squared-error sum all-reduced;
    * SSIM: the CUDA kernel (``ssim_flat_sum``, the ``hopper`` route) on this
      rank's columns plus 6 from its right neighbour, flat ``[H,
      (wloc+6)*4]``, which makes its valid windows exactly the rank's own
      window starts; the starts that read pad or ring-wrapped columns
      (``pl`` on the first rank, ``pr + 6`` on the last) are subtracted
      through the plain ``ssim_sum``, the sums all-reduced and divided by
      the frame's ``(H-6)*(W-6)*4`` windows.

    Gathering the frame moves ``H * W * 16`` bytes across the group;
    ``gather=False`` (a caller that reads only the metrics) returns ``None``
    in its place and in the input panel's.

    A packed ``[.., 16]`` lr is refused, as by the single-device step.
    ``halo`` is a multiple of 8 and at least the model's receptive-field
    radius (UNetSeeInDark: about 94). A frame too narrow to shard takes the
    single-device step (JAX's own fallback).
    """
    nsp = mesh.n_spatial
    if halo % 8:
        raise ValueError(f"halo {halo} is not a multiple of 8")
    fallback = make_eval_metrics_step(model, qparams=qparams)
    in_nc = getattr(model, "in_nc", 4)
    if qparams is not None:
        from pnnp_tpu_torch.models.unet_s2d_int8 import unet_hybrid_forward_packed_int8

        tparams = fallback.tparams
        forward = lambda x: d2s(unet_hybrid_forward_packed_int8(tparams(), qparams, s2d(x),
                                                                model.dtype)).float()
    else:
        forward = lambda x: model(x).float()

    def ssim_shard_sum(a4, b4, pl, pr, wloc):
        # a4/b4: [1, H, wloc+6, 4] in [0, 1]; this rank's share of the
        # frame's SSIM map sum
        H = a4.shape[1]
        a, b = a4 * 255.0, b4 * 255.0
        total = ssim_flat_sum(a.reshape(H, -1), b.reshape(H, -1), C=4).double()
        i = mesh.spatial_rank
        if i == 0 and pl > 0:  # starts [0, pl) read the left pad columns
            total = total - ssim_sum_plain(a[0, :, :pl + 6], b[0, :, :pl + 6]).double()
        if i == nsp - 1:  # starts [wloc-pr-6, wloc): right pad or ring-wrapped
            total = total - ssim_sum_plain(a[0, :, wloc - pr - 6:],
                                           b[0, :, wloc - pr - 6:]).double()
        return total

    def tail(dn4, hr_s, lr_in4, r, geom, ori, correct):
        """dn4 [1, H, wloc, 4] cropped; hr_s this rank's padded columns."""
        H, W, pt, pl, pr, wloc = geom
        i = mesh.spatial_rank
        dev = dn4.device
        hrf = hr_s[0, pt:pt + H].float().reshape(H, -1)
        dnf = dn4[0].reshape(H, -1)
        gcol = i * wloc + torch.arange(wloc, device=dev)
        m = ((gcol >= pl) & (gcol < pl + W)).float().repeat_interleave(4)[None, :]
        lrf = lr_in4[0].float().reshape(H, -1) if lr_in4 is not None else None
        if ori:
            dnf = dnf * r
            lrf = lrf * r if lrf is not None else None
        dnf = dnf.clamp(0.0, 1.0)
        lrf = lrf.clamp(0.0, 1.0) if lrf is not None else None
        hrc = hrf.clamp(0.0, 1.0)
        if correct:
            w = (hrf != 1.0).float() * m
            num, den = spatial_sum(mesh, torch.stack([torch.sum(dnf * hrf * w),
                                                      torch.sum(dnf * dnf * w)]))
            scale = torch.where(den > 0, num / den.clamp_min(1e-20), torch.ones_like(den))
            dnf = scale * dnf
        # one exchange: 6 columns of the right neighbour's dn, hr (and lr)
        planes = [dnf, hrc] + ([lrf] if lrf is not None else [])
        own = torch.stack([t.reshape(1, H, wloc, 4) for t in planes])
        _, recv = _ring(mesh, own[:, :, :, :6].contiguous())
        slabs = torch.cat([own, recv], dim=3)  # [k, 1, H, wloc+6, 4]
        se = lambda a: torch.sum(((a - hrc) * 255.0) ** 2 * m)
        sums = [se(dnf), ssim_shard_sum(slabs[0], slabs[1], pl, pr, wloc).float()]
        if lrf is not None:
            sums += [se(lrf), ssim_shard_sum(slabs[2], slabs[1], pl, pr, wloc).float()]
        sums = spatial_sum(mesh, torch.stack(sums))
        npx, nwin = float(H * W * 4), float((H - 6) * (W - 6) * 4)
        psnr = lambda s: 10.0 * torch.log10(255.0 ** 2 / (s / npx).clamp_min(1e-12))
        metrics = {"psnr": psnr(sums[0]), "ssim": sums[1] / nwin}
        if lrf is not None:  # the save_plot meters (trainer_SID.py:291-297)
            metrics.update(psnr_in=psnr(sums[2]), ssim_in=sums[3] / nwin)
        return slabs[0, :, :, :wloc], metrics, (slabs[2, :, :, :wloc] if lrf is not None
                                                 else None)

    @torch.no_grad()
    def step(lr, hr, ratio, *, ori=False, correct=True, with_inputs=False, gather=True):
        if lr.dim() == 3:
            lr = lr.reshape(1, lr.shape[1], -1, 4)
        if hr.dim() == 3:
            hr = hr.reshape(1, hr.shape[1], -1, 4)
        refuse_packed_frame(lr, in_nc)
        H, W = int(hr.shape[1]), int(hr.shape[2])
        pt, pb = pad_split(H, 16)
        pl, pr = pad_split(W, 16 * nsp)
        Hp, Wp = H + pt + pb, W + pl + pr
        wloc = Wp // nsp
        viable = (nsp > 1 and wloc > 2 * halo and H > 8 and W > 8
                  and wloc >= pl + 6 and wloc >= pr + 12  # the corrections fit
                  and Wp - W < W and Hp - H < H)  # the reflect pad is legal
        if not viable:
            return fallback(lr, hr, ratio, ori=ori, correct=correct,
                            with_inputs=with_inputs)
        i = mesh.spatial_rank
        hr_s = _reflect_pad_nhwc(hr, pt, pb, pl, pr)[:, :, i * wloc:(i + 1) * wloc]
        lr_s = _reflect_pad_nhwc(lr, pt, pb, pl, pr)[:, :, i * wloc:(i + 1) * wloc]
        slab = _halo_slab(mesh, lr_s, halo)
        dn = forward(slab.permute(0, 3, 1, 2))
        lr_in4 = lr_s[:, pt:pt + H] if with_inputs else None
        dn4 = dn[:, :, pt:pt + H, halo:-halo].permute(0, 2, 3, 1)
        r = torch.as_tensor(ratio, dtype=torch.float32, device=dn4.device).reshape(())
        dn_own, metrics, lr_own = tail(dn4, hr_s, lr_in4, r, (H, W, pt, pl, pr, wloc),
                                       ori, correct)
        frame = lambda t: (_gather_columns(mesh, t)[:, :, pl:pl + W].reshape(1, H, W * 4)
                           if gather else None)
        if with_inputs:
            return frame(dn_own), metrics, frame(lr_own)
        return frame(dn_own), metrics

    step.tparams = fallback.tparams
    return step
