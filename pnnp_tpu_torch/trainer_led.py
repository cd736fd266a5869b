"""LED identity-eval harness (counterpart of ``pnnp_tpu/trainer_led.py``;
reference: trainer_LED.py).

Scores raw noisy inputs (or externally denoised results) under the same
metric pipeline with NO denoiser: ``imgs_dn = imgs_lr`` (reference:
trainer_LED.py:111), through the Trainer's unfused eval branch. Useful for
input-PSNR reference points and for evaluating third-party outputs. Unlike
the LRID trainer, trainer_LED illuminance-corrects phone data too
(trainer_LED.py:122).

    python -m pnnp_tpu_torch.trainer_led -f runfile [--mode eval] [--nofig]

runs on the card; ``main(argv, device="cpu")`` on the host.
"""

from __future__ import annotations

import argparse
from typing import Optional

from pnnp_tpu_torch.trainer import Trainer, eval_sweep


class LEDTrainer(Trainer):
    _phone_eval_corrects = True

    def __init__(self, runfile: str, mode: Optional[str] = "eval", **kw):
        super().__init__(runfile, mode=mode, **kw)
        # identity "network": the model is bypassed, the fused eval step
        # (which would run the real forward) included
        self.eval_step = lambda lr_img: lr_img.float()
        self._fused_eval = None


def main(argv=None, device=None):
    """CLI entry; runs on the card unless ``device`` names another
    (``device="cpu"`` on the host). Returns the trainer."""
    p = argparse.ArgumentParser()
    p.add_argument("--runfile", "-f", required=True)
    p.add_argument("--mode", "-m", default="eval")
    p.add_argument("--nofig", action="store_true")
    a = p.parse_args(argv)
    t = LEDTrainer(a.runfile, mode=a.mode, nofig=a.nofig, device=device)
    # the main trainer's dispatch: change_eval_ratio first (phone datasets
    # read self.dgain; a ratio_list assignment would keep the default ratio)
    eval_sweep(t, t.dataset_eval, list(t.dst_eval.get("ratio_list", [])))
    return t


if __name__ == "__main__":
    main()
