"""The Poisson sampler and the tools of the real-data, proxy-research and
int8-serving groups on the card.

These tests need an NVIDIA GPU (``cuda`` marker) and skip on a host without
one. This file imports no JAX, so it also runs on a machine without it:

    python -m pytest tests/test_torch_cuda_tools.py -m cuda --noconftest -q

* The sampler against ``scipy.stats.poisson`` at lam in {1, 4, 16, 23, 64,
  100}: 2^22 draws each, mean and variance within 2% of lam, the pmf KLD
  within 4x its sampling floor; each draw uncorrelated with the uniform the
  generator's next call gives the same element (|corr| < 5 / sqrt(n): the
  stream reserve of ``ops/poisson.py``).
* ``golden_parity`` on the tiny synthetic trees of
  tests/test_evaltest_harness.py, on the card: exit 2 with a missing
  index, 1 against ``CONFIGS``, 0 against the run's own numbers.
* The proxy and int8 tools at their small sizes on the card: they run,
  their JSON and rows have the CPU run's form, and the closed-form columns
  of ``diagnose_proxy_fit`` agree with the CPU's within 1e-5 relative.
"""

import json
import pickle
import re

import numpy as np
import pytest
import torch
import yaml

LAMS = (1.0, 4.0, 16.0, 23.0, 64.0, 100.0)


@pytest.fixture()
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the sampler's and the tools' card checks")
    return torch.device("cuda")


@pytest.mark.cuda
def test_poisson_sampler_on_card(card):
    from pnnp_tpu_torch.tools.check_poisson import sampler_rows, stream_rows

    for r in sampler_rows(card, LAMS, n=1 << 22):
        assert abs(r["mean_rel"]) < 0.02 and abs(r["var_rel"]) < 0.02, r
        assert r["kl"] < 4 * r["kl_floor"], r
    for r in stream_rows(card, LAMS, n=1 << 20):
        assert abs(r["corr_port"]) < 5 / np.sqrt(r["n"]), r


@pytest.mark.cuda
def test_golden_parity_on_card(card, tmp_path, monkeypatch, capsys):
    from test_evaltest_harness import H, NF, W, make_eld_tree, make_sid_tree, make_torch_state

    from pnnp_tpu_torch.tools import golden_parity as gp
    from pnnp_tpu_torch.tools.get_dataset_infos import main as build_infos

    monkeypatch.chdir(tmp_path)
    rng = np.random.default_rng(5)
    make_sid_tree(str(tmp_path / "SID"), rng)
    make_eld_tree(str(tmp_path / "ELD"), rng)
    infos = str(tmp_path / "infos")
    build_infos(["--dstname", "ELD", "--root_dir", str(tmp_path / "ELD"), "--out_dir", infos])
    ckpt = str(tmp_path / "released.pth")
    torch.save(make_torch_state(np.random.default_rng(9)), ckpt)
    dst = {"dstname": "SID", "command": "", "camera_type": "SonyA7S2", "noise_code": "p",
           "patch_size": 8, "H": H, "W": W, "crop_per_image": 1, "croptype": "random_crop",
           "wp": 16383, "bl": 512, "ori": False, "clip": 2}
    run = {"mode": "evaltest", "checkpoint": "saved_model/T", "fast_ckpt": "checkpoints/T",
           "model_name": "GPCARD_Unet", "num_workers": 0, "brightness_correct": True,
           "dst": dst,
           "dst_eval": dict(dst, mode="eval", dataset="ELD_Dataset",
                            iso_list=[800, 1600, 3200], ratio_list=[100, 200]),
           "arch": {"name": "UNetSeeInDark", "in_nc": 4, "out_nc": 4, "nf": NF,
                    "nframes": 1, "res": False},
           "hyper": {"lr_scheduler": "fixed", "learning_rate": 1e-4, "batch_size": 1,
                     "last_epoch": 0, "stop_epoch": 1, "save_freq": 1, "plot_freq": 1,
                     "best_psnr": 0}}
    with open(tmp_path / "gp.yml", "w") as f:
        yaml.safe_dump(run, f)
    monkeypatch.setitem(gp.CONFIGS, "TEST", dict(gp.CONFIGS["SonyA7S2_PNNP"],
                                                 runfile=str(tmp_path / "gp.yml")))
    base = ["--config", "TEST", "--infos_dir", infos, "--ckpt", ckpt]
    assert gp.main(base + ["--workdir", str(tmp_path / "w0")]) == 2
    build_infos(["--dstname", "SID", "--root_dir", str(tmp_path / "SID"), "--mode", "evaltest",
                 "--out_dir", infos])
    assert gp.main(base + ["--workdir", str(tmp_path / "w1")]) == 1
    out = capsys.readouterr().out
    assert json.loads(out.strip().splitlines()[-1])["sweeps"] == 5
    with open("logs/log_GPCARD_Unet.log") as f:
        own = gp.parse_summaries(f.read())[-5:]
    sweeps = [(label, p, s) for (label, _, _), (p, s) in zip(gp.CONFIGS["TEST"]["sweeps"], own)]
    monkeypatch.setitem(gp.CONFIGS, "TEST", dict(gp.CONFIGS["TEST"], sweeps=sweeps))
    assert gp.main(base + ["--workdir", str(tmp_path / "w2")]) == 0
    assert re.search(r'"status": "pass"', capsys.readouterr().out)


@pytest.mark.cuda
def test_proxy_tools_on_card(card, tmp_path):
    from pnnp_tpu_torch.models import params_to_jax
    from pnnp_tpu_torch.models.proxy import PixelWiseISOProxy
    from pnnp_tpu_torch.tools import diagnose_proxy_fit, oracle_proxy_family, oracle_row_deconv

    path = tmp_path / "p.pkl"
    proxy = PixelWiseISOProxy(d=64, generator=torch.Generator().manual_seed(3))
    with open(path, "wb") as f:
        pickle.dump(params_to_jax(proxy.state_dict()), f)
    argv = [str(path), "--d", "64", "--isos", "800", "12800"]
    got, ref = diagnose_proxy_fit.main(argv), diagnose_proxy_fit.main(argv + ["--cpu"])
    for g, r in zip(got, ref):
        for k in ("px_var_model", "px_tail_pi", "px_tail_b", "row_tail_pi", "row_tail_b"):
            assert g[k] == pytest.approx(r[k], rel=1e-5), k
        assert g["row_std"] == pytest.approx(r["row_std"], rel=0.02)
    rows = oracle_row_deconv.main(["--d", "32", "--steps", "20", "--fit-batch", "2048",
                                   "--w", "32", "--isos", "12800"])
    assert len(rows) == 2 and all(np.isfinite(r["kld_vs_gauss"]) for r in rows)
    (row,) = oracle_proxy_family.main(["--d", "32", "--steps", "20", "--fit-batch", "4096",
                                       "--eval-frames", "2", "--big-eval-frames", "4",
                                       "--isos", "12800"])
    assert np.isfinite(row["kld"]) and row["kld_floor"] < row["kld"]


@pytest.mark.cuda
def test_int8_tools_on_card(card, capsys):
    from pnnp_tpu_torch.models.unet_s2d_int8 import BANDS
    from pnnp_tpu_torch.tools import (
        ablate_int8_quantset,
        bench_int8,
        int8_roofline,
        profile_prefix_int8,
    )

    rows = ablate_int8_quantset.main(["--small", "--frames", "2", "--repeats", "2"])
    assert [r["subset"] for r in rows] == list(ablate_int8_quantset.SUBSETS)
    prefix = profile_prefix_int8.main(["--small", "--iters", "2", "--repeats", "2"])
    assert [n for n, _ in prefix] == list(profile_prefix_int8.NAMES)
    cases = bench_int8.main(["--small"])
    assert all(c["int8_ms"] > 0 and c["bf16_ms"] > 0 for c in cases)
    capsys.readouterr()
    bands = int8_roofline.main(["--small", "--iters", "2", "--probe-int4"])
    tail = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert [b["band"] for b in bands] == list(BANDS) and tail["int4"] == {
        "error": int8_roofline.NO_INT4}
