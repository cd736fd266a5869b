"""Trainer: runfile-driven evaluation on the card (counterpart of
``pnnp_tpu/trainer.py``).

Same CLI surface (``python -m pnnp_tpu_torch.trainer -f runfile --mode
{eval,test,evaltest,dump}``), same YAML runfiles, same log lines, metrics
pickle and checkpoint files. Eval serves UNetSeeInDark in bf16 (f32 with
``disable_fast_path: true``) through one fused step: forward, clip,
illuminance correction, PSNR and the CUDA SSIM kernel.

Not ported yet, and raising ``NotImplementedError`` with their ROADMAP item:
the ``train``/``trainonly`` modes (1.3-1.4), ``--int8`` serving (1.15),
``rgb_metrics`` (1.14) and :meth:`Trainer.predict` (1.14). With ``save_plot``
the input meters are computed, but figure rendering (1.14) is skipped with
one logged line.
"""

from __future__ import annotations

import argparse
import os
import pickle
from typing import Optional

import numpy as np
import torch

from pnnp_tpu_torch.config import command_of, load_runfile
from pnnp_tpu_torch.data import DataLoader, build_dataset
from pnnp_tpu_torch.models import build_model, params_from_jax
from pnnp_tpu_torch.ops import illuminance_correct
from pnnp_tpu_torch.train import (
    CheckpointManager,
    load_any,
    make_eval_metrics_step,
    make_eval_step,
)
from pnnp_tpu_torch.utils.device import resolve_device
from pnnp_tpu_torch.utils.logging import AverageMeter, log

_FIGURES_SKIPPED = ("figure rendering is not ported yet (ROADMAP 1.14: ISP); "
                    "sample figures skipped")


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
    def __init__(self, runfile: str, mode: Optional[str] = None, nofig: bool = False,
                 debug: bool = False, root_prefix: Optional[str] = None, seed: int = 1997,
                 int8: bool = False, device=None):
        self.args = load_runfile(runfile, mode=mode, root_prefix=root_prefix)
        self.mode = self.args["mode"]
        if self.mode in ("train", "trainonly"):
            raise NotImplementedError(
                f"mode '{self.mode}': training is not ported yet (ROADMAP "
                "1.3-1.4); this package serves eval/test/evaltest/dump")
        if int8:
            raise NotImplementedError(
                "--int8 serving is not ported yet (ROADMAP 1.15)")
        if self.args.get("rgb_metrics", False):
            raise NotImplementedError(
                "rgb_metrics needs the device ISP, not ported yet (ROADMAP 1.14)")
        self.device = resolve_device(device)
        self.dst = self.args["dst"]
        self.hyper = self.args["hyper"]
        self.arch = self.args["arch"]
        self.model_name = self.args["model_name"]
        self.save_plot = not nofig
        self.debug = debug
        self.seed = seed

        self.logfile = f"./logs/log_{self.model_name}.log"
        self.sample_dir = os.path.join(self.args.get("result_dir", "images"),
                                       f"samples-{self.model_name}")
        os.makedirs(self.sample_dir, exist_ok=True)
        os.makedirs("./logs", exist_ok=True)
        os.makedirs("./metrics", exist_ok=True)

        # --- model ---------------------------------------------------------
        # UNetSeeInDark serves in bf16 (bf16 weights and activations, f32
        # after the forward), like the JAX fused eval's transform_params_hybrid
        # default; disable_fast_path serves in f32, like make_eval_step(fast=False).
        bf16 = (self.arch.get("name") == "UNetSeeInDark"
                and not self.arch.get("use_dpsv", False)
                and not self.args.get("disable_fast_path", False))
        self.dtype = torch.bfloat16 if bf16 else torch.float32
        gen = torch.Generator().manual_seed(seed)
        self.model = build_model(self.arch, dtype=self.dtype,
                                 generator=gen).to(self.device).eval()

        # --- checkpoints ---------------------------------------------------
        self.ckpt = CheckpointManager(
            self.args.get("fast_ckpt", "checkpoints"),
            self.args.get("checkpoint", "saved_model"),
            self.model_name,
            save_freq=self.hyper.get("save_freq", 10),
        )
        self.ckpt.best_psnr = self.hyper.get("best_psnr", 0)
        self._try_restore()

        # --- datasets ------------------------------------------------------
        self.dst_eval = self.args.get("dst_eval")
        self.dst_test = self.args.get("dst_test")
        self.dataset_eval = None
        if self.dst_eval:
            self.dataset_eval = build_dataset(self.dst_eval, seed=seed)

        # --- steps ---------------------------------------------------------
        self.eval_step = make_eval_step(self.model)
        self._fused_eval = make_eval_metrics_step(self.model)

        # --- meters --------------------------------------------------------
        self.eval_psnr = AverageMeter("PSNR", ":2f")
        self.eval_ssim = AverageMeter("SSIM", ":4f")
        self.eval_psnr_lr = AverageMeter("PSNR", ":2f")
        self.eval_ssim_lr = AverageMeter("SSIM", ":4f")
        self.eval_psnr_dn = AverageMeter("PSNR", ":2f")
        self.eval_ssim_dn = AverageMeter("SSIM", ":4f")
        self._print_model_log()

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
            f"Devices:\t1 ({self.device}, {str(self.dtype).replace('torch.', '')})",
        ]
        for line in lines:
            log(line, logfile=self.logfile, notime=True)

    def _load_params(self, params):
        self.model.load_state_dict(params_from_jax(params), strict=True)

    def _try_restore(self):
        # eval modes want the best-PSNR weights (best -> last -> fresh init)
        restored = self.ckpt.restore("best")
        if restored is not None:
            self._load_params(restored["params"])
            log(f"Restored checkpoint (epoch {restored['meta'].get('epoch')})")
        else:
            log("No checkpoint found; using fresh init")

    def load_torch_checkpoint(self, path: str):
        self._load_params(load_any(path)["params"])
        log(f"Loaded torch checkpoint {path}")

    def _to_device(self, a) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _brightness_correct(self, dst: dict) -> bool:
        # The reference's LRID trainer never calls IlluminanceCorrect in eval
        # (trainer_LRID.py:62 vs :195-319), so IMX686 evals stay uncorrected;
        # only the SID/ELD eval corrects (trainer_SID.py:238).
        if str(dst.get("dataset", "")).startswith("IMX686"):
            return False
        return bool(self.args.get("brightness_correct", True))

    # ------------------------------------------------------------------
    def eval(self, epoch: int = -1):
        """Eval loop with the reference's metric/log contract
        (trainer_SID.py:181-320), every metric computed on the device."""
        assert self.dataset_eval is not None
        for m in (self.eval_psnr, self.eval_ssim, self.eval_psnr_lr,
                  self.eval_ssim_lr, self.eval_psnr_dn, self.eval_ssim_dn):
            m.reset()
        metrics_path = f"./metrics/{self.model_name}_metrics.pkl"
        metrics = {}
        if os.path.exists(metrics_path):
            with open(metrics_path, "rb") as f:
                metrics = pickle.load(f)

        correct = self._brightness_correct(self.dst_eval) and epoch < 0
        ori = bool(self.dst_eval.get("ori", self.dst.get("ori", False)))
        if self.save_plot and epoch < 0:
            log(_FIGURES_SKIPPED)
        loader = DataLoader(self.dataset_eval, batch_size=1, shuffle=False,
                            num_workers=0 if self.debug else 2)
        for k, batch in enumerate(loader):
            name = batch["name"][0] if isinstance(batch["name"], list) else batch["name"]
            out = self._fused_eval(
                self._to_device(batch["lr"]), self._to_device(batch["hr"]),
                float(np.asarray(batch["ratio"]).reshape(-1)[0]),
                ori=ori, correct=correct, with_inputs=self.save_plot,
            )
            m = out[1]
            p, s = float(m["psnr"]), float(m["ssim"])
            self.eval_psnr.update(p)
            self.eval_ssim.update(s)
            metrics[name] = [p, s]
            if self.save_plot:
                self.eval_psnr_lr.update(float(m["psnr_in"]))
                self.eval_ssim_lr.update(float(m["ssim_in"]))
                self.eval_psnr_dn.update(p)
                self.eval_ssim_dn.update(s)
            log(f"[{k + 1}/{len(loader)}] {name}: PSNR={p:.2f} SSIM={s:.4f}")

        if not self.save_plot:
            self.eval_psnr_dn, self.eval_ssim_dn = self.eval_psnr, self.eval_ssim
        log(
            f"Epoch {epoch}: PSNR={self.eval_psnr.avg:.2f}\n"
            f"psnrs_lr={self.eval_psnr_lr.avg:.2f}, psnrs_dn={self.eval_psnr_dn.avg:.2f}\n"
            f"ssims_lr={self.eval_ssim_lr.avg:.4f}, ssims_dn={self.eval_ssim_dn.avg:.4f}",
            logfile=self.logfile,
        )
        if epoch < 0:
            with open(metrics_path, "wb") as f:
                pickle.dump(metrics, f)

    # ------------------------------------------------------------------
    def test(self, out_dir: Optional[str] = None):
        """Denoise the test split and save outputs as .npy, the reference's
        ``test`` mode (trainer_SID.py:362-420)."""
        dst = self.dst_test or self.dst_eval
        assert dst is not None, "no dst_test/dst_eval block in runfile"
        dataset = build_dataset(dict(dst, mode="eval"), seed=self.seed)
        out_dir = out_dir or os.path.join(self.sample_dir, "test")
        os.makedirs(out_dir, exist_ok=True)
        correct = self._brightness_correct(dst)
        ori = bool(dst.get("ori", self.dst.get("ori", False)))
        if self.save_plot:
            log(_FIGURES_SKIPPED)

        def dump_split():
            loader = DataLoader(dataset, batch_size=1, shuffle=False,
                                num_workers=0)
            for k, batch in enumerate(loader):
                dn = self.eval_step(self._to_device(batch["lr"]))
                if ori and "ratio" in batch:  # brighten before clamp
                    dn = dn * self._to_device(batch["ratio"]).reshape(-1, 1, 1, 1)
                dn = dn.clamp(0, 1)
                # the reference's output pass corrects against the GT before
                # saving (trainer_SID.py:396-397)
                if correct and "hr" in batch:
                    dn = illuminance_correct(dn, self._to_device(batch["hr"]))
                name = batch["name"][0] if isinstance(batch["name"], list) else str(batch["name"])
                np.save(os.path.join(out_dir, f"{name}_dn.npy"), dn[0].cpu().numpy())
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

    def predict(self, raw_mosaic: np.ndarray, name: str | None = "ds",
                patch_size: int = 512, base: int = 64):
        """Tiled full-frame inference (reference: trainer_SID.py:345-360)."""
        raise NotImplementedError(
            "predict needs the tiled apply of ops/tiling.py, not ported yet "
            "(ROADMAP 1.14)")


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


def main(argv=None):
    """CLI entry; runs on ``cuda:<--gpu>``. Returns the Trainer."""
    p = Parser.parse(argv)
    trainer = Trainer(p.runfile, mode=p.mode, nofig=p.nofig, debug=p.debug,
                      int8=p.int8, device=f"cuda:{p.gpu}")
    mode = trainer.mode
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
