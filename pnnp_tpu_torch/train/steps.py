"""Train and eval steps (counterpart of ``pnnp_tpu/train/steps.py``).

Train half: the synth stages that turn a host batch into a noisy / clean
pair on the device (``make_raw_synth``, the physics synth of the Raw_Dataset
family and, in black-frame mode, of SFRN; ``make_proxy_synth``, the learned
proxy's, for the Proxy_Dataset family; ``make_mix_synth``, PMN's shot-noise
augmentation of real pairs, for the Mix family; ``identity_synth``, for real
pairs), and the train step:
synth -> clip -> forward + L1 loss -> backward -> Adam scaled by
``lr(epoch)``. Images are NCHW tensors on the device; every random draw
comes from the ``torch.Generator`` passed to the step.

Eval half (``pad_split``, ``pad_to_multiple``, ``make_eval_metrics_step``,
``make_eval_step``; ``pnnp_tpu/train/steps.py:354-489`` in JAX): padded
full-frame forward fused with the eval metrics. Its public layouts are the
JAX package's: NHWC frames, or channel-interleaved flat ``[1, H, W*4]``; the
steps convert to NCHW only around the model.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F

from pnnp_tpu_torch.kernels.ssim import ssim_flat
from pnnp_tpu_torch.models.unet_s2d import (
    d2s,
    packed_from_host,
    s2d,
    transform_params_hybrid,
    unet_hybrid_forward_packed,
)
from pnnp_tpu_torch.ops.correct import illuminance_correct
from pnnp_tpu_torch.physics.calibration import HALF_CLIP, LEGAL_ISO
from pnnp_tpu_torch.physics.noise import (
    generate_noisy,
    generate_noisy_packed,
    get_aug_param,
    sna,
)
from pnnp_tpu_torch.physics.sampling import sample_params_max
from pnnp_tpu_torch.train.losses import unet_loss
from pnnp_tpu_torch.train.state import apply_scaled_updates


def clip_lr_hr(lr, hr, clip_mode):
    """Reference clip semantics (trainer_SID.py:481-485): clip=2 (HALF_CLIP)
    keeps the sensor's negative read-noise floor on lr; clip=1 clamps to 0."""
    if clip_mode:
        lr = lr.clamp_max(1.0) if clip_mode == HALF_CLIP else lr.clamp(0.0, 1.0)
        hr = hr.clamp(0.0, 1.0)
    return lr, hr


def _gtdn_ratio(generator: torch.Generator, n: int) -> torch.Tensor:
    """'GTdn' command ratio law: max(U(-3, 4), 1) per example — mostly 1
    (GT-denoising mode), occasionally up to 4 (reference syn_datasets.py:334)."""
    u = torch.rand(n, generator=generator, device=generator.device)
    return (u * 7.0 - 3.0).clamp_min(1.0)


def _noiseparam_table(camera_type, iso, noiseparam):
    """ISO-table override from a user noiseparam-iso-N.h5 dict (or None)."""
    if noiseparam is None or iso is None:
        return None
    from pnnp_tpu_torch.physics.calibration import table_with_noiseparam

    return table_with_noiseparam(camera_type, iso, noiseparam)


def _raw_synth_params(generator, camera_type, n, iso, ratio, gtdn, lrid, table=None):
    """Parameter draw of the raw synth.

    ``lrid=True`` applies the trainer_LRID.py:399-418 IMX686 law: the
    dataset's point-calibrated ISO params with ONLY K jittered (sigmas at
    their means) and a per-example LINEAR ``ratio ~ U(1, 16)`` — distinct
    from process.py:344-348's generic exp-uniform law.
    """
    if lrid:
        ratio = torch.rand(n, generator=generator, device=generator.device) * 15.0 + 1.0
    params = sample_params_max(generator, camera_type, n=n, ratio=ratio, iso=iso,
                               jitter_sigmas=not lrid, table=table)
    if gtdn:
        params = dict(params, ratio=_gtdn_ratio(generator, n))
    return params


def make_raw_synth(camera_type: str, noise_code: str, ori: bool, clip: bool,
                   iso=None, ratio=None, gtdn: bool = False,
                   lrid: bool = False, noiseparam: Optional[dict] = None):
    """Physics noise synthesis on clean GT crops, batched:
    ``synth(generator, batch) -> (lr, hr, ratio)`` with ``batch["hr"]``
    [n, 4, h, w] on the device.

    ``noiseparam``: user-supplied per-ISO calibration (the reference's
    ``noiseparam-iso-N.h5`` ingestion, phone_datasets.py:99-112) overriding
    the baked table row for ``iso``."""
    table = _noiseparam_table(camera_type, iso, noiseparam)

    def synth(generator, batch):
        hr = batch["hr"]
        params = _raw_synth_params(generator, camera_type, hr.shape[0], iso, ratio,
                                   gtdn, lrid, table)
        lr = generate_noisy(generator, hr, params, noise_code, ori=ori, clip=bool(clip))
        return lr, hr, params["ratio"]

    return synth


def make_raw_synth_packed(camera_type: str, noise_code: str, ori: bool, clip: bool,
                          iso=None, ratio=None, gtdn: bool = False,
                          lrid: bool = False, noiseparam: Optional[dict] = None):
    """:func:`make_raw_synth` in the packed layout: the same draws and
    distribution (row banding exact, :func:`generate_noisy_packed`), lr and
    hr ``[n, 16, h/2, w/2]`` for the packed train step. ``batch["hr"]`` may
    come unpacked ``[n, 4, h, w]`` (packed here, once) or packed."""
    table = _noiseparam_table(camera_type, iso, noiseparam)

    def synth(generator, batch):
        hr = batch["hr"]
        if hr.shape[1] == 4:
            hr = s2d(hr)
        params = _raw_synth_params(generator, camera_type, hr.shape[0], iso, ratio,
                                   gtdn, lrid, table)
        lr = generate_noisy_packed(generator, hr, params, noise_code, ori=ori,
                                   clip=bool(clip))
        return lr, hr, params["ratio"]

    return synth


def pack_synth(synth: Callable) -> Callable:
    """An unpacked synth stage for the packed train step: lr and hr packed
    once, after synthesis (no gradient flows through data)."""

    def packed(generator, batch):
        lr, hr, ratio = synth(generator, batch)
        if lr.shape[1] == 4:
            lr, hr = s2d(lr), s2d(hr)
        return lr, hr, ratio

    return packed


def make_proxy_synth(sample_fn: Callable, ori: bool = False,
                     ratio_range=(100.0, 300.0), ratio_ladder=None,
                     iso_from_batch: bool = False):
    """Noise from a learned proxy: ``sample_fn(generator, clean, iso) ->
    noise`` (normalized), as ``synth(generator, batch) -> (lr, hr, ratio)``.

    Two reference sampling laws:

    * Sony (trainer_SID.py:463-472), the default: per-example
      ``ratio ~ U(ratio_range)`` and ONE ISO per batch drawn uniformly from
      the legal-ISO ladder.
    * IMX686 (trainer_LRID.py:419-427), with ``ratio_ladder`` and
      ``iso_from_batch``: ONE ratio per batch drawn uniformly from the
      ladder (the LRID dgains 1, 2, 4, 8, 16) and the ISO of the batch's own
      dataset (``batch["iso"][0]``, the proxy's calibration point).

    Draws stay on the generator's device (no host sync); the ISO reaches
    ``sample_fn`` as a 1-element tensor.
    """

    def synth(generator, batch):
        hr = batch["hr"]
        n = hr.shape[0]
        dev = generator.device
        if ratio_ladder is not None:
            ladder = torch.tensor(ratio_ladder, dtype=torch.float32, device=dev)
            ridx = torch.randint(len(ladder), (1,), generator=generator, device=dev)
            ratio = ladder[ridx].expand(n)
        else:
            lo, hi = ratio_range
            ratio = torch.rand(n, generator=generator, device=dev) * (hi - lo) + lo
        if iso_from_batch:
            iso = batch["iso"].reshape(-1)[:1].float()
        else:
            legal = torch.as_tensor(LEGAL_ISO, device=dev)
            iso = legal[torch.randint(len(legal), (1,), generator=generator, device=dev)]
        rb = ratio.reshape(-1, 1, 1, 1)
        noise = sample_fn(generator, hr / rb, iso)
        # ori keeps lr at the dark (unamplified) exposure, as generate_noisy's
        # ori branch: dark signal + dark-scale noise
        lr = hr + noise * rb if not ori else hr / rb + noise
        return lr, hr, ratio

    return synth


def _per_crop(x: torch.Tensor, n: int, width: int = 0) -> torch.Tensor:
    """A per-batch-item value as one row per crop: ``[n]`` (``width`` 0) or
    ``[n, width]``. The loader's collate keeps one row per item for a python
    scalar or a 1-D array (a bool ``black_lr``, a ``wb`` [4]); with
    ``batch_size`` 1 that row broadcasts, as in JAX."""
    x = x.float().reshape(-1, width) if width else x.float().reshape(-1)
    if x.shape[0] != n:
        x = x.repeat_interleave(n // x.shape[0], dim=0)
    return x


def make_mix_synth(camera_type: str, command: str = "augv5", ori: bool = False,
                   hbr_map: Optional[Callable] = None, host_amplified: bool = False):
    """PMN-style SNA over *real* noisy/clean pairs, as ``synth(generator,
    batch) -> (lr, hr, ratio)``.

    ``batch`` holds hr, lr [n, 4, h, w], ratio [n], iso [n], wb and,
    optionally, black_lr: a bool or a per-crop 0/1 array marking crops whose
    lr is a pasted real bias frame (reference: trainer_SID.py:430-447,
    phone_datasets.py:585-640). ``hbr_map(generator, lr) -> lr`` is the
    HighBitRecovery remap of the bias-frame crops (quantized read noise ->
    continuous, reference: phone_datasets.py:632).

    ``host_amplified``: the loader already multiplied lr by ratio (the IMX686
    loaders do, inheriting the paired path); the synth then skips its own
    multiply, so that the amplification happens exactly once.
    """

    def synth(generator, batch):
        hr, lr = batch["hr"], batch["lr"]
        n = hr.shape[0]
        ratio = batch["ratio"].reshape(-1)
        wb = _per_crop(batch["wb"], n, 4)
        aug_r, aug_g, aug_b = get_aug_param(generator, wb, n, command, camera_type)
        aug_wb = torch.stack([aug_r, aug_g, aug_b, aug_g], dim=1)
        black = batch.get("black_lr")
        black = (torch.zeros(n, device=hr.device) if black is None
                 else _per_crop(torch.as_tensor(black, device=hr.device), n))
        aug_wb = aug_wb + black[:, None]
        rb = ratio.reshape(-1, 1, 1, 1)
        if hbr_map is not None:
            # The LUT addresses UNAMPLIFIED ADU bins (the reference remaps the
            # raw bias crops before its preprocess multiplies by the dgain,
            # phone_datasets.py:631, trainer_LRID.py:378): a host-amplified
            # lr is unamplified around the remap.
            amp = rb if (host_amplified and not ori) else 1.0
            lr = torch.where(black.reshape(-1, 1, 1, 1) > 0,
                             hbr_map(generator, lr / amp) * amp, lr)
        if not (ori or host_amplified):
            lr = lr * rb
        dn, dy = sna(generator, hr, aug_wb, camera_type=camera_type, ratio=ratio,
                     iso=batch.get("iso"), black_lr=black, ori=ori)
        return lr + dn, hr + dy, ratio

    return synth


def identity_synth(generator, batch):
    """Real paired data (paired training): no synthesis."""
    hr = batch["hr"]
    ratio = batch.get("ratio")
    if ratio is None:
        ratio = torch.ones(hr.shape[0], device=hr.device)
    return batch["lr"], hr, ratio


# The memory of a module's 4-D parameters for bf16 compute: channels_last,
# where cuDNN runs the convolutions NHWC without the NCHW <-> NHWC
# transforms it puts around each one otherwise. chip_smoke.py's same-call
# A/B (PERF.md section 6; NVIDIA H100 80GB HBM3, 700.00 W), NCHW ->
# channels_last: the bf16 train step at 8 x 512^2 pgrq 27.471 -> 20.253 ms,
# the bf16 fused eval step 16.855 -> 12.938 ms at the IMX686 frame and
# 10.102 -> 9.979 at the Sony frame. f32 (TF32 off) stays NCHW, where
# channels_last was slower: train 131.978 -> 143.175 ms, IMX686 eval
# 52.351 -> 59.589.
BF16_MEMORY_FORMAT = torch.channels_last


def to_memory_format(model, memory_format) -> None:
    """Moves a module's 4-D parameters (and their gradients) into
    ``memory_format`` in place, where they are not in it yet. Values, shapes
    and the parameter objects stay: an optimizer built on them keeps them."""
    if not all(p.is_contiguous(memory_format=memory_format)
               for p in model.parameters() if p.dim() == 4):
        model.to(memory_format=memory_format)


def _serving_memory_format(model, memory_format=None) -> None:
    """An eval step's module in ``memory_format``, by default
    :data:`BF16_MEMORY_FORMAT` for a bf16 model (f32 as it comes)."""
    if memory_format is None and getattr(model, "dtype", None) == torch.bfloat16:
        memory_format = BF16_MEMORY_FORMAT
    if memory_format is not None:
        to_memory_format(model, memory_format)


class TrainStep:
    """``step(model, opt, batch, generator, epoch) -> metrics``.

    synth (no gradient) -> :func:`clip_lr_hr` -> forward + :func:`unet_loss`
    -> backward -> Adam scaled by ``lr_schedule(epoch)``. ``model`` holds
    float32 master parameters and ``opt`` is its
    :func:`~pnnp_tpu_torch.train.state.make_adam`. Metrics: ``loss`` and
    ``psnr`` (on the clipped prediction and target, float32) as 0-dim
    tensors on the device, ``lr`` as a float.

    ``bf16=True`` runs the forward and the loss under ``torch.autocast`` in
    bfloat16 (the JAX package's fast path: f32 master params, bf16 forward);
    otherwise the step is exact float32, with TF32 off.

    ``packed=True`` (UNetSeeInDark; JAX's ``fast="packed"``) runs the whole
    step in the packed layout: the synth yields ``[n, 16, h/2, w/2]`` lr/hr
    (:func:`make_raw_synth_packed`, or :func:`pack_synth` around another),
    the forward is :func:`~pnnp_tpu_torch.models.unet_s2d.unet_hybrid_forward_packed`
    on the :func:`~pnnp_tpu_torch.models.unet_s2d.transform_params_hybrid`
    fold of the model's own parameters, in bf16 or f32 as above but cast
    explicitly, as JAX does, not under autocast; the fold is differentiable,
    so the gradients land on the standard parameters. L1 and MSE do not see
    the permutation: loss and psnr are the unpacked step's.

    The module forward runs on parameters in ``memory_format`` memory,
    moved there in place at the first step: by default
    :data:`BF16_MEMORY_FORMAT` in bf16, f32 as they come.

    The stages are methods so that they can be timed one by one:
    :meth:`make_pair`, :meth:`forward_backward`, :meth:`update`.
    """

    def __init__(self, lr_schedule: Callable, synth: Callable = identity_synth,
                 clip_mode=0, bf16: bool = False, packed: bool = False,
                 memory_format: Optional[torch.memory_format] = None):
        self.lr_schedule = lr_schedule
        self.synth = synth
        self.clip_mode = clip_mode
        self.bf16 = bf16
        self.packed = packed
        if memory_format is None and bf16 and not packed:
            memory_format = BF16_MEMORY_FORMAT
        self.memory_format = memory_format

    @torch.no_grad()
    def make_pair(self, batch, generator):
        lr_img, hr_img, _ = self.synth(generator, batch)
        return clip_lr_hr(lr_img, hr_img, self.clip_mode)

    def forward_backward(self, model, lr_img, hr_img):
        """Fills the parameters' ``.grad``; returns (loss, pred), detached."""
        if self.memory_format is not None:
            to_memory_format(model, self.memory_format)
        model.zero_grad(set_to_none=True)
        if self.packed:
            dtype = torch.bfloat16 if self.bf16 else torch.float32
            if not self.bf16:
                _exact_f32(model)
            tp = transform_params_hybrid(model, dtype)
            pred = unet_hybrid_forward_packed(tp, lr_img, lr_img if model.res else None, dtype)
            loss = unet_loss(pred, hr_img)
        elif self.bf16:
            with torch.autocast(lr_img.device.type, dtype=torch.bfloat16):
                pred = model(lr_img)
                loss = unet_loss(pred, hr_img)
        else:
            _exact_f32(model)
            pred = model(lr_img)
            loss = unet_loss(pred, hr_img)
        loss.backward()
        return loss.detach(), pred.detach()

    def update(self, opt, epoch) -> float:
        lr = float(self.lr_schedule(epoch))
        apply_scaled_updates(opt, lr)
        return lr

    def __call__(self, model, opt, batch, generator, epoch) -> dict:
        lr_img, hr_img = self.make_pair(batch, generator)
        loss, pred = self.forward_backward(model, lr_img, hr_img)
        lr = self.update(opt, epoch)
        with torch.no_grad():
            mse = torch.mean((pred.clamp(0.0, 1.0) - hr_img.clamp(0.0, 1.0)) ** 2)
            psnr = 10.0 * torch.log10(1.0 / mse.clamp_min(1e-12))
        return {"loss": loss, "psnr": psnr, "lr": lr}


def make_train_step(lr_schedule: Callable, synth: Callable = identity_synth,
                    clip_mode=0, deep_supervision: bool = False,
                    bf16: bool = False, packed: bool = False,
                    memory_format: Optional[torch.memory_format] = None) -> TrainStep:
    """Build the train step (see :class:`TrainStep`)."""
    if deep_supervision:
        raise NotImplementedError(
            "deep supervision (use_dpsv) training is not ported yet (ROADMAP 1.13)")
    return TrainStep(lr_schedule, synth, clip_mode=clip_mode, bf16=bf16, packed=packed,
                     memory_format=memory_format)


def pad_split(n: int, mult: int = 16):
    """(lo, hi) symmetric split of the pad needed to reach %mult — the
    general form of the reference's fixed ``F.pad(p2d=(4,4,4,4))``
    (trainer_SID.py:221-226 / trainer_LRID.py:224-229: both camera shapes
    have residue 8, i.e. 4 per side)."""
    p = (-n) % mult
    return p // 2, p - p // 2


def _pad_nchw(x: torch.Tensor, mult: int):
    H, W = x.shape[-2], x.shape[-1]
    (pt, pb), (pl, pr) = pad_split(H, mult), pad_split(W, mult)
    if pt or pb or pl or pr:
        x = F.pad(x, (pl, pr, pt, pb), mode="reflect")
    return x, (pt, pl, H, W)


def pad_to_multiple(x: torch.Tensor, mult: int = 16):
    """Symmetric reflect-pad an NHWC ``[N, H, W, C]`` frame to a multiple of
    ``mult`` (reference pads 4 per side before the UNet and center-crops
    after, trainer_SID.py:221-226). Returns (padded, (oy, ox, H, W)); crop
    the output with ``pred[:, oy:oy+H, ox:ox+W, :]``."""
    xp, geom = _pad_nchw(x.permute(0, 3, 1, 2), mult)
    return xp.permute(0, 2, 3, 1), geom


def _exact_f32(model) -> None:
    # An f32 model on the card must compute in full f32, as the JAX f32
    # path does: cuDNN would otherwise run f32 convolutions in TF32 (about
    # three decimal digits). Matmuls are f32 by default; set both anyway.
    if model.dtype == torch.float32 and next(model.parameters()).is_cuda:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False


def _forward_cropped(model, x_nchw: torch.Tensor) -> torch.Tensor:
    """%16 reflect pad -> model -> center crop, NCHW float32."""
    xp, (oy, ox, H, W) = _pad_nchw(x_nchw.float(), 16)
    return model(xp)[:, :, oy:oy + H, ox:ox + W]


def params_key(model) -> tuple:
    """The identity of a module's parameter values: each parameter's storage
    and in-place version. It changes when the parameters are replaced or
    written in place (``load_state_dict``, an optimizer step)."""
    return tuple((p.data_ptr(), p._version) for p in model.parameters())


class HybridParams:
    """``transform_params_hybrid(model, model.dtype)``, computed once and
    again only when :func:`params_key` of the model changes."""

    def __init__(self, model):
        self.model = model
        self.key = None
        self.tparams = None

    def __call__(self) -> dict:
        key = params_key(self.model)
        if key != self.key:
            with torch.no_grad():
                self.tparams = transform_params_hybrid(self.model, self.model.dtype)
            self.key = key
        return self.tparams


def make_eval_metrics_step(model, qparams: Optional[dict] = None, packed: bool = False,
                           memory_format: Optional[torch.memory_format] = None):
    """Fused full-frame eval: forward + clip + illuminance correction +
    PSNR + SSIM (the CUDA kernel on the card) in one call.

    step(lr, hr, ratio, *, ori=False, correct=True, with_inputs=False) ->
    (dn_flat [1, H, W*4] corrected+clipped, metrics with psnr/ssim
    [/psnr_in/ssim_in]) and, with ``with_inputs``, the (ori-scaled, clipped)
    input panel ``lr_panel`` [1, H, W*4] as a third element. ``lr``/``hr``
    are flat ``[1, H, W*4]`` or ``[1, H, W, 4]`` tensors on the model's
    device; ``lr`` may also come pre-packed by the host
    (:func:`~pnnp_tpu_torch.models.unet_s2d.pack_frame_np`: %16 reflect pad
    and s2d, NHWC ``[1, H'/2, W'/2, 16]``), the crop then taken from ``hr``'s
    shape. Reference eval semantics (trainer_SID.py:221-248): ori
    amplification, clip, correct dn against hr, score at data_range 255.

    The forward: the NCHW module (default), or with ``packed`` the hybrid
    packed form (:func:`~pnnp_tpu_torch.models.unet_s2d.unet_hybrid_forward_packed`,
    JAX's forward here) on weights transformed once per parameter version;
    with ``qparams`` (from
    :func:`~pnnp_tpu_torch.models.unet_s2d_int8.quantize_params_int8`) the
    W8A8 forward, the metrics in f32 as ever (a ``res`` model is refused).
    The model runs in its own dtype (bf16 serving, or f32) and hands back
    float32. ``step.tparams()`` gives the transformed weights. The module
    forward's parameters move into ``memory_format`` memory here, in place
    (by default :data:`BF16_MEMORY_FORMAT` for a bf16 model, f32 as it
    comes).
    """
    _exact_f32(model)
    if not packed and qparams is None:
        _serving_memory_format(model, memory_format)
    in_nc = getattr(model, "in_nc", 4)
    res = bool(getattr(model, "res", False))
    if qparams is not None:
        if res:
            raise ValueError("the int8 serving path has no residual-input support")
        from pnnp_tpu_torch.models.unet_s2d_int8 import unet_hybrid_forward_packed_int8

        fwd = lambda tp, g1: unet_hybrid_forward_packed_int8(tp, qparams, g1, model.dtype)
        packed = True
    else:
        fwd = lambda tp, g1: unet_hybrid_forward_packed(tp, g1, g1 if res else None,
                                                        model.dtype)
    tparams = HybridParams(model)

    @torch.no_grad()
    def step(lr, hr, ratio, *, ori=False, correct=True, with_inputs=False):
        if lr.dim() == 3:  # flat [1, H, W*4] -> logical 4-channel view
            lr = lr.reshape(1, lr.shape[1], -1, 4)
        if hr.dim() == 3:
            hr = hr.reshape(1, hr.shape[1], -1, 4)
        H, W = hr.shape[1], hr.shape[2]
        # host pre-packed: only unambiguous for a model of 4-channel frames
        # (a 16-channel lr of an in_nc=16 model is an unpacked input)
        host_packed = lr.shape[-1] == 16 and in_nc == 4
        if host_packed:
            g1 = packed_from_host(lr)
            oy, ox = pad_split(H)[0], pad_split(W)[0]
            crop = lambda t: t[:, :, oy:oy + H, ox:ox + W]
        if packed:
            if not host_packed:
                x, (oy, ox, _, _) = _pad_nchw(lr.permute(0, 3, 1, 2).float(), 16)
                crop = lambda t: t[:, :, oy:oy + H, ox:ox + W]
                g1 = s2d(x)
            dn = crop(d2s(fwd(tparams(), g1))).float()
        elif host_packed:
            dn = crop(model(d2s(g1).float()))
        else:
            dn = _forward_cropped(model, lr.permute(0, 3, 1, 2))
        dnf = dn[0].permute(1, 2, 0).reshape(H, -1)  # [H, W*4] dense copy
        if with_inputs:  # the only consumer of the unpacked input frame
            lr_un = crop(d2s(g1)).permute(0, 2, 3, 1) if host_packed else lr
            lrf = lr_un[0].float().reshape(H, -1)
        if ori:
            r = torch.as_tensor(ratio, dtype=torch.float32,
                                device=dnf.device).reshape(())
            dnf = dnf * r
            if with_inputs:
                lrf = lrf * r
        dnf = dnf.clamp(0.0, 1.0)
        if with_inputs:
            lrf = lrf.clamp(0.0, 1.0)
        hrf = hr[0].float().reshape(H, -1)
        hrc = hrf.clamp(0.0, 1.0)
        if correct:
            dnf = illuminance_correct(dnf.reshape(H, -1, 4),
                                      hrf.reshape(H, -1, 4)).reshape(H, -1)

        def psnr_of(a, b):
            mse = torch.mean((a * 255.0 - b * 255.0) ** 2)
            return 10.0 * torch.log10(255.0**2 / mse.clamp_min(1e-12))

        metrics = {
            "psnr": psnr_of(dnf, hrc),
            "ssim": ssim_flat(dnf * 255.0, hrc * 255.0),
        }
        if with_inputs:  # the save_plot meters (trainer_SID.py:291-297)
            metrics["psnr_in"] = psnr_of(lrf, hrc)
            metrics["ssim_in"] = ssim_flat(lrf * 255.0, hrc * 255.0)
            return dnf[None], metrics, lrf[None]
        return dnf[None], metrics

    step.tparams = tparams
    return step


def make_eval_step(model):
    """eval_step(lr_img [N, H, W, C]) -> denoised [N, H, W, out_nc] float32,
    with %16 reflect padding (the plain forward ``dump`` mode uses); a bf16
    model in :data:`BF16_MEMORY_FORMAT` memory."""
    _exact_f32(model)
    _serving_memory_format(model)

    @torch.no_grad()
    def step(lr_img):
        return _forward_cropped(model, lr_img.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)

    return step
