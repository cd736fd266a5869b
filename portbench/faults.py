"""Faults planted in the port's timed path, to show that the comparison
deciding ``correct`` sees them (``portbench/tests``) and to read what each
gives at a cell's own size (``python3 -m portbench.readings --fault``).

Each is a context manager that patches the port while it is active:

* ``unchanged``: the optimizer's update does nothing, so every step leaves
  its state as it was.
* ``half``: the step's loss and gradients come from half of its batch (the
  train step's first half of the crops; the proxy step, whose batch is one
  frame, the first half of its rows), the mean taken over the rest.
* ``noise``: the proxy's noise sample is scaled by 1.2 where it is drawn.
* ``ssim``: the eval step's SSIM is altered by +0.01 where it is produced.
* ``frame``: the eval step's network output is altered by +0.05 where it is
  produced.
"""

from __future__ import annotations

from contextlib import contextmanager

import torch


@contextmanager
def _patched(obj, name, value):
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


@contextmanager
def unchanged():
    import pnnp_tpu_torch.train.steps as steps
    import pnnp_tpu_torch.trainer_nf as nf

    with _patched(steps.TrainStep, "update", lambda self, opt, epoch: 0.0), \
            _patched(nf.NoiseStep, "update", lambda self, opt, epoch: 0.0):
        yield


@contextmanager
def half():
    import pnnp_tpu_torch.train.steps as steps
    import pnnp_tpu_torch.trainer_nf as nf

    train_fb, noise_fb = steps.TrainStep.forward_backward, nf.NoiseStep.forward_backward

    def train_half(self, model, lr_img, hr_img):
        n = max(lr_img.shape[0] // 2, 1)
        return train_fb(self, model, lr_img[:n], hr_img[:n])

    def train_metrics(self, loss, pred, hr_img, lr, reduce=None):
        return {"loss": loss, "psnr": torch.zeros((), device=loss.device), "lr": lr}

    def noise_half(self, opt, lr_img, hr_img, ratio, iso):
        h = lr_img.shape[2] // 2
        return noise_fb(self, opt, lr_img[:, :, :h], hr_img[:, :, :h], ratio, iso)

    with _patched(steps.TrainStep, "forward_backward", train_half), \
            _patched(steps.TrainStep, "metrics", train_metrics), \
            _patched(nf.NoiseStep, "forward_backward", noise_half):
        yield


@contextmanager
def noise():
    from pnnp_tpu_torch.models.proxy import PixelWiseISOProxy

    real = PixelWiseISOProxy.sample
    with _patched(PixelWiseISOProxy, "sample",
                  lambda self, clean, iso, generator: 1.2 * real(self, clean, iso, generator)):
        yield


@contextmanager
def ssim():
    import pnnp_tpu_torch.train.steps as steps

    real = steps.ssim_flat
    with _patched(steps, "ssim_flat", lambda x, y, *a, **k: real(x, y, *a, **k) + 0.01):
        yield


@contextmanager
def frame():
    import pnnp_tpu_torch.train.steps as steps

    real = steps._forward_cropped
    with _patched(steps, "_forward_cropped", lambda m, x: real(m, x) + 0.05):
        yield


FAULTS = {"unchanged": unchanged, "half": half, "noise": noise, "ssim": ssim,
          "frame": frame}
