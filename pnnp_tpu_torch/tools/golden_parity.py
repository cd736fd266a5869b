"""One-command real-data golden-parity runner against the reference's four
logs (counterpart of ``tools/golden_parity.py``).

It pre-flights the on-disk layout, converts the released torch checkpoint
into the port's best-model slot, runs the port's ``--mode evaltest`` CLI
(``pnnp_tpu_torch.trainer.main``) in f32 (``disable_fast_path``), parses
the 3-line log summaries and diffs every sweep against the reference
numbers that BASELINE.md transcribes (with file:line cites). Every frame of
the sweep goes through the fused eval step and its SSIM kernel.

Prep (once, offline):
  1. Decode the camera raws to npy caches + JSON sidecars:
       python tools/decode_cache.py --root <SID_root> ...   (needs rawpy)
  2. Build the index pickles:
       python -m pnnp_tpu_torch.tools.get_dataset_infos --dstname SID \\
           --root_dir <SID_root> --mode evaltest --out_dir <infos>
       python -m pnnp_tpu_torch.tools.get_dataset_infos --dstname ELD \\
           --root_dir <ELD_root> --out_dir <infos>
       python -m pnnp_tpu_torch.tools.get_dataset_infos --dstname LRID \\
           --root_dir <LRID_root> --subset indoor_x5 --out_dir <infos>   (+ outdoor_x3)
  3. Fetch the released torch checkpoints (reference README): state_dicts
     for UNetSeeInDark; ``load_any`` maps the names.

Run (on the card unless ``--cpu``):
  python -m pnnp_tpu_torch.tools.golden_parity --config SonyA7S2_PNNP \\
      --ckpt <SonyA7S2_PNNP_Unet.pth> --infos_dir <infos>

Exit 0: every sweep within tolerance; 1: a parity failure; 2: a missing
prerequisite (printed with how to produce it).
"""

from __future__ import annotations

import argparse
import json
import os
import re
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# Expected (psnr_dn, ssim_dn) per sweep, in log order. Source: BASELINE.md
# (transcribed from the reference's logs/*.log with line cites).
CONFIGS = {
    "SonyA7S2_PNNP": {
        "runfile": "runfiles/SonyA7S2/PNNP.yml",
        "sweeps": [("ELD x100", 47.31, 0.9877), ("ELD x200", 45.47, 0.9791),
                   ("SID x100", 43.63, 0.9614), ("SID x250", 41.49, 0.9498),
                   ("SID x300", 38.01, 0.9353)],
        "infos": ["ELD_SonyA7S2.info", "SID_evaltest.info"],
    },
    "SonyA7S2_PMNNP": {
        "runfile": "runfiles/SonyA7S2/PMNNP.yml",
        "sweeps": [("ELD x100", 47.13, 0.9872), ("ELD x200", 45.21, 0.9770),
                   ("SID x100", 43.55, 0.9613), ("SID x250", 41.16, 0.9491),
                   ("SID x300", 38.04, 0.9362)],
        "infos": ["ELD_SonyA7S2.info", "SID_evaltest.info"],
    },
    "IMX686_PNNP": {
        "runfile": "runfiles/IMX686/PNNP.yml",
        "sweeps": [("indoor_x5 x1", 48.50, 0.9908),
                   ("indoor_x5 x2", 46.94, 0.9863),
                   ("indoor_x5 x4", 45.06, 0.9797),
                   ("indoor_x5 x8", 42.64, 0.9662),
                   ("indoor_x5 x16", 40.30, 0.9460),
                   ("outdoor_x3 x1", 45.62, 0.9873),
                   ("outdoor_x3 x2", 44.27, 0.9821),
                   ("outdoor_x3 x4", 42.63, 0.9724)],
        "infos": ["indoor_x5_GT_align_ours.info", "indoor_x5_short.info",
                  "outdoor_x3_GT_align_ours.info", "outdoor_x3_short.info"],
    },
    "IMX686_PMNNP": {
        "runfile": "runfiles/IMX686/PMNNP.yml",
        "sweeps": [("indoor_x5 x1", 49.40, 0.9918),
                   ("indoor_x5 x2", 47.58, 0.9868),
                   ("indoor_x5 x4", 45.41, 0.9806),
                   ("indoor_x5 x8", 43.08, 0.9667),
                   ("indoor_x5 x16", 40.07, 0.9432),
                   ("outdoor_x3 x1", 46.36, 0.9886),
                   ("outdoor_x3 x2", 44.94, 0.9835),
                   ("outdoor_x3 x4", 43.01, 0.9692)],
        "infos": ["indoor_x5_GT_align_ours.info", "indoor_x5_short.info",
                  "outdoor_x3_GT_align_ours.info", "outdoor_x3_short.info"],
    },
}

_NUM = r"-?[\d.]+"  # SSIM can be negative for a broken checkpoint
SUMMARY = re.compile(rf"psnrs_lr={_NUM}, psnrs_dn=({_NUM})\nssims_lr={_NUM}, ssims_dn=({_NUM})")


def _runfile_path(cfg) -> str:
    p = cfg["runfile"]
    return p if os.path.isabs(p) else os.path.join(REPO, p)


def parse_summaries(logtext: str) -> list:
    """The ``(psnr_dn, ssim_dn)`` of every 3-line eval summary in a log."""
    return [(float(p), float(s)) for p, s in SUMMARY.findall(logtext)]


def preflight(cfg, args) -> list[str]:
    problems = []
    if not os.path.exists(_runfile_path(cfg)):
        problems.append(f"runfile {cfg['runfile']} missing (run from repo root)")
    if not os.path.exists(args.ckpt):
        problems.append(
            f"checkpoint {args.ckpt} not found — download the released "
            "torch state_dict for this config (reference README) and pass "
            "--ckpt")
    for name in cfg["infos"]:
        p = os.path.join(args.infos_dir, name)
        if not os.path.exists(p):
            problems.append(
                f"index {p} missing — build it with "
                "python -m pnnp_tpu_torch.tools.get_dataset_infos"
                " (see the module docstring, step 2)")
    return problems


def run_config(name: str, cfg: dict, args, device) -> list[dict]:
    import yaml

    from pnnp_tpu_torch.train.checkpoint import load_any, save_checkpoint
    from pnnp_tpu_torch.trainer import main as trainer_main

    with open(_runfile_path(cfg)) as f:
        run = yaml.safe_load(f)

    model_name = run["model_name"]
    # the converted checkpoint into the best-model slot evaltest loads
    params = load_any(args.ckpt)["params"]
    ckpt_dir = os.path.join(args.workdir, "checkpoints")
    os.makedirs(ckpt_dir, exist_ok=True)
    save_checkpoint(os.path.join(ckpt_dir, f"{model_name}_best_model.ckpt"),
                    params, None, {"epoch": 0, "eval_psnr": 1.0})
    run["fast_ckpt"] = ckpt_dir
    # f32 eval math for the 0.05 dB budget: the port keeps the fused step
    # in f32 (JAX goes unfused), the same numbers
    run["disable_fast_path"] = True
    for key in ("dst", "dst_train", "dst_eval", "dst_test"):
        if isinstance(run.get(key), dict):
            run[key]["infos_dir"] = args.infos_dir

    legs = []
    if run["dst"]["camera_type"] == "SonyA7S2":
        # the ELD sweep from dst_eval, then the SID evaltest sweep on the
        # real test set (the training runfile's dst_test is the synth one)
        run["dst_test"] = dict(run["dst_eval"], dataset="SID_Dataset",
                               dstname="SID", mode="evaltest",
                               ratio_list=[100, 250, 300])
        run["dst_test"].pop("iso_list", None)
        legs.append(run)
    else:
        # LRID: the indoor_x5 ladder, then outdoor_x3 (its own index)
        legs.append(dict(run, dst_test=None))
        legs.append(dict(run, dst_test=None,
                         dst_eval=dict(run["dst_eval"], dstname="outdoor_x3",
                                       ratio_list=[1, 2, 4])))

    logfile = os.path.join("logs", f"log_{model_name}.log")
    if os.path.exists(logfile):
        os.rename(logfile, logfile + ".bak")
    for i, leg in enumerate(legs):
        ypath = os.path.join(args.workdir, f"{name}_{i}.yml")
        with open(ypath, "w") as f:
            yaml.safe_dump(leg, f)
        argv = ["-f", ypath, "--mode", "evaltest", "--nofig"]
        if args.debug:
            argv.append("--debug")  # serial in-process loading
        trainer_main(argv, device=str(device))

    with open(logfile) as f:
        pairs = parse_summaries(f.read())
    expected = cfg["sweeps"]
    got = pairs[-len(expected):]
    rows = []
    for (label, p_ref, s_ref), (p, s) in zip(expected, got):
        rows.append({
            "sweep": label, "psnr": p, "psnr_ref": p_ref,
            "dpsnr": round(p - p_ref, 3), "ssim": s, "ssim_ref": s_ref,
            "dssim": round(s - s_ref, 4),
            "pass": abs(p - p_ref) <= args.tol_db and abs(s - s_ref) <= args.tol_ssim,
        })
    if len(got) < len(expected):
        rows.append({"sweep": "MISSING SWEEPS", "pass": False,
                     "detail": f"log had {len(pairs)} summaries"})
    return rows


def main(argv=None, device=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", required=True, choices=sorted(CONFIGS))
    ap.add_argument("--ckpt", required=True, help="released torch .pth for this config")
    ap.add_argument("--infos_dir", default="infos")
    ap.add_argument("--debug", action="store_true",
                    help="serial data loading (no worker threads)")
    ap.add_argument("--tol_db", type=float, default=0.05)
    ap.add_argument("--tol_ssim", type=float, default=0.002)
    ap.add_argument("--workdir", default=None)
    ap.add_argument("--cpu", action="store_true")
    a = ap.parse_args(argv)
    if a.workdir is None:
        a.workdir = tempfile.mkdtemp(prefix="golden_parity_")

    cfg = CONFIGS[a.config]
    problems = preflight(cfg, a)
    if problems:
        print("Missing prerequisites:")
        for p in problems:
            print(f"  - {p}")
        print(json.dumps({"config": a.config, "status": "prereq_missing",
                          "missing": len(problems)}))
        return 2

    import torch

    from pnnp_tpu_torch.utils.device import resolve_device

    dev = torch.device("cpu") if a.cpu else resolve_device(device)
    rows = run_config(a.config, cfg, a, dev)
    ok = all(r["pass"] for r in rows)
    w = max(len(r["sweep"]) for r in rows)
    for r in rows:
        if "psnr" in r:
            print(f"{r['sweep']:<{w}}  PSNR {r['psnr']:6.2f} vs {r['psnr_ref']:6.2f} "
                  f"({r['dpsnr']:+.3f})  SSIM {r['ssim']:.4f} vs "
                  f"{r['ssim_ref']:.4f} ({r['dssim']:+.4f})  "
                  f"{'PASS' if r['pass'] else 'FAIL'}")
    print(json.dumps({"config": a.config,
                      "status": "pass" if ok else "fail",
                      "sweeps": len(rows),
                      "failed": sum(not r["pass"] for r in rows)}))
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
