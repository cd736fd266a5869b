"""The proxy's training half against the JAX package's: the proxy synth,
the NLL step, the NF trainer, and ``Proxy_Dataset`` training.

* ``make_proxy_synth``: the Sony law (per-example ratio ~ U(100, 300), one
  legal-ladder ISO per batch) and the IMX686 law (one ratio per batch from
  the LRID ladder, the batch's own ISO), as tests/test_phone_and_nf.py:217
  checks the JAX one; the lr formula with and without ``ori``.
* The f32 proxy step against JAX ``make_proxy_train_step`` on the same
  weights and batches, with and without ``clip_norm``: params after 1 and 3
  steps at rtol 1e-4 / atol 1e-5. The residuals are dark-noise-like (inside
  the heads' support), where both packages' f32 gradients sit within 1e-5
  of a float64 evaluation (tests/test_torch_proxy.py).
* ``NFTrainer --kind proxy`` for 2 epochs on a SID fixture against the JAX
  ``NFTrainer`` from the same init params (single device): the ``last``
  checkpoint at rtol 1e-4 / atol 1e-5, the log lines' fields and files.
* ``kl_div_norm_device`` equal to JAX's (1e-6); the CDF tools (1e-5).
* ``--mode trainonly`` of a ``Proxy_Dataset`` runfile (nf=4) driven by a
  ``proxy_checkpoint`` the JAX ``NFTrainer`` wrote, and ``--mode train`` of
  a PNNP-style runfile without one (a fresh proxy, as PNNP.yml) into the
  ``evaltest`` sweep.
* ``tools/validate_proxy.py`` at a 20-step budget: finite, one JSON line;
  ``tools/ladder_spread.py`` over two seeds and from a given init pickle.
"""

import json
import os
import pickle
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

import pnnp_tpu.trainer_nf as jax_nf
from pnnp_tpu.models.proxy import PixelWiseISOProxy as JProxy
from pnnp_tpu.ops.kld import kl_div_norm_device as jax_kld
from pnnp_tpu.train.checkpoint import load_any as jax_load_any
from pnnp_tpu.train.state import TrainState, make_adam_direction
from pnnp_tpu_torch.data.fixtures import make_sid_fixture, make_sid_runfile, place_eval_split
from pnnp_tpu_torch.models import PixelWiseISOProxy, params_to_jax
from pnnp_tpu_torch.ops.kld import kl_div_norm_device
from pnnp_tpu_torch.physics.calibration import LEGAL_ISO
from pnnp_tpu_torch.train import load_any, make_adam, make_proxy_synth
from pnnp_tpu_torch.trainer import Trainer
from pnnp_tpu_torch.trainer import main as trainer_main
from pnnp_tpu_torch.trainer_nf import NFTrainer, make_proxy_train_step
from pnnp_tpu_torch.trainer_nf import main as nf_main

D, NF, NB = 64, 8, 2
SPAN = 16383.0 - 512.0
PROXY_ARCH = {"name": "pw_iso_2stage", "ISO2K": [0.0009546, -0.00193], "nf": NF,
              "nb": NB, "d": D, "mode": "2stage+iso"}
NF_LINE = re.compile(r"Epoch (\d+): nll/dim=(\S+) \(\S+s\)")
KLD_LINE = re.compile(r"Epoch (\d+): KLD fwd=(\S+) inv=(\S+) sym=(\S+)")


def _write(path, run):
    with open(path, "w") as f:
        yaml.safe_dump(run, f)
    return str(path)


def _trees_close(a, b, rtol=1e-4, atol=1e-5):
    la, lb = jax.tree_util.tree_leaves_with_path(a), jax.tree_util.tree_leaves_with_path(b)
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (path, x), (_, y) in zip(la, lb):
        np.testing.assert_allclose(np.asarray(x), np.asarray(y), rtol=rtol, atol=atol,
                                   err_msg=str(path))


# ------------------------------------------------------------------ synth
def _recording_sample(seen):
    def sample_fn(generator, clean, iso):
        seen.append(iso.clone())
        return torch.full_like(clean, 0.01)
    return sample_fn


@pytest.mark.parametrize("law", ["sony", "imx686"])
def test_make_proxy_synth_laws(law):
    hr = torch.from_numpy(np.random.default_rng(0).uniform(0, 0.2, (4, 4, 8, 8))
                          .astype(np.float32))
    batch = {"hr": hr, "iso": torch.full((4,), 6400.0)}
    seen, ratios = [], []
    kw = ({} if law == "sony" else
          dict(ratio_ladder=(1, 2, 4, 8, 16), iso_from_batch=True))
    synth = make_proxy_synth(_recording_sample(seen), **kw)
    gen = torch.Generator().manual_seed(0)
    for _ in range(64):
        lr, out_hr, ratio = synth(gen, batch)
        assert out_hr is hr and ratio.shape == (4,)
        torch.testing.assert_close(lr, hr + 0.01 * ratio.reshape(-1, 1, 1, 1))
        ratios.append(ratio.numpy())
    r = np.stack(ratios)
    isos = torch.cat(seen).numpy()
    assert all(s.shape == (1,) for s in seen)
    if law == "sony":
        assert (r >= 100).all() and (r <= 300).all() and len(np.unique(r)) == r.size
        assert abs(r.mean() - 200) < 10
        assert set(isos) <= set(LEGAL_ISO.tolist()) and len(set(isos)) > 10
    else:
        assert (r == r[:, :1]).all()  # one ratio per batch
        assert set(r[:, 0]) == {1.0, 2.0, 4.0, 8.0, 16.0}
        assert set(isos) == {6400.0}
    # ori: lr stays at the dark exposure
    ori = make_proxy_synth(_recording_sample([]), ori=True, **kw)
    lr, _, ratio = ori(gen, batch)
    torch.testing.assert_close(lr, hr / ratio.reshape(-1, 1, 1, 1) + 0.01)


# -------------------------------------------------------------- NLL step
def _paired_batches(k=3, n=2, h=8, w=12, seed=0):
    """(lr, hr, ratio, iso) NHWC: dark-ish clean signal, dark-noise-like
    residual of a few ADU (inside the init heads' support)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(k):
        ratio = rng.uniform(100, 300, n).astype(np.float32)
        hr = rng.uniform(0, 0.05, (n, h, w, 4)).astype(np.float32)
        noise = (rng.normal(0, 3, (n, h, w, 4)) + rng.normal(0, 1, (n, h, 1, 4))) / SPAN
        lr = (hr + noise * ratio[:, None, None, None]).astype(np.float32)
        iso = np.array([800.0, 3200.0][:n], np.float32)
        out.append((lr, hr, ratio, iso))
    return out


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


@pytest.mark.parametrize("clip_norm", [None, 0.05])
def test_proxy_step_matches_jax(clip_norm):
    proxy = PixelWiseISOProxy(d=D, nf=NF, nb=NB, generator=torch.Generator().manual_seed(4))
    init = params_to_jax(proxy.state_dict())
    params = jax.tree.map(jnp.asarray, init)  # donated by the JAX step
    lr_fn = lambda e: 1e-3 * (1 + e)
    jstep = jax_nf.make_proxy_train_step(JProxy(d=D, nf=NF, nb=NB), lr_fn)
    state = TrainState.create(apply_fn=None, params=params,
                              tx=make_adam_direction(clip_norm=clip_norm))
    opt = make_adam(proxy.parameters())
    tstep = make_proxy_train_step(proxy, lr_fn, clip_norm=clip_norm)
    for i, (lr, hr, ratio, iso) in enumerate(_paired_batches()):
        state, jm = jstep(state, jnp.asarray(lr), jnp.asarray(hr), jnp.asarray(ratio),
                          jnp.asarray(iso), i)
        tm = tstep(opt, _nchw(lr), _nchw(hr), torch.from_numpy(ratio),
                   torch.from_numpy(iso), i)
        for k in ("nll", "nll_px", "nll_row"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5)
        assert tm["lr"] == pytest.approx(float(jm["lr"]))
        if i in (0, 2):
            _trees_close(params_to_jax(proxy.state_dict()), state.params)
    moved = max(float(np.abs(np.asarray(a) - b).max()) for a, b in
                zip(jax.tree.leaves(state.params), jax.tree.leaves(init)))
    assert moved > 1e-3


def test_kl_div_norm_device_matches_jax():
    rng = np.random.default_rng(3)
    for shift in (True, False):
        p = rng.normal(0, 20, (4, 32, 32)).astype(np.float32)
        q = (rng.normal(0, 22, (4, 32, 32)) + rng.standard_t(3, (4, 32, 32))).astype(np.float32)
        if not shift:
            p, q = np.abs(p) * 400, np.abs(q) * 400 + 16500  # the top bin, clipped
        ref = jax_kld(jnp.asarray(p), jnp.asarray(q), bl=512.0, wp=16383)
        got = kl_div_norm_device(torch.from_numpy(p), torch.from_numpy(q), bl=512.0, wp=16383)
        for k in ("kl_fwd", "kl_inv", "kl_sym"):
            np.testing.assert_allclose(float(got[k]), float(ref[k]), rtol=1e-6, atol=1e-7)
        assert float(got["kl_sym"]) > 0.001


def test_cdf_tools_match_jax():
    """cdf_interp, quantile_loss and cdf_loss against the JAX package's."""
    from pnnp_tpu.ops import kld as jk
    from pnnp_tpu_torch.ops import kld as tk

    rng = np.random.default_rng(4)
    out = rng.normal(0, 2, 4096).astype(np.float32)
    gt = (rng.standard_t(4, 4096) * 1.8).astype(np.float32)
    probe = np.linspace(-8, 8, 97).astype(np.float32)
    quant = np.linspace(0.01, 0.99, 33).astype(np.float32)
    srt = np.sort(gt)
    np.testing.assert_allclose(tk.cdf_interp(torch.from_numpy(srt), torch.from_numpy(probe)).numpy(),
                               np.asarray(jk.cdf_interp(jnp.asarray(srt), jnp.asarray(probe))),
                               rtol=1e-6, atol=1e-7)
    for name, q in (("quantile_loss", quant), ("cdf_loss", probe)):
        got = getattr(tk, name)(torch.from_numpy(out), torch.from_numpy(gt), torch.from_numpy(q))
        ref = getattr(jk, name)(jnp.asarray(out), jnp.asarray(gt), jnp.asarray(q))
        assert float(ref) > 1e-3, name
        np.testing.assert_allclose(float(got), float(ref), rtol=1e-5, err_msg=name)


# ------------------------------------------------------------ NF trainer
def _nf_runfile(root, side):
    run = make_sid_runfile(root, "NF_Proxy", patch_size=8, H=32, W=48, batch_size=1,
                           stop_epoch=2)
    run.update(arch=dict(PROXY_ARCH), checkpoint=str(root / side / "saved_model"),
               fast_ckpt=str(root / side / "checkpoints"))
    run["dst_train"]["dataset"] = "SID_Dataset"
    run["hyper"].update(plot_freq=2, save_freq=1)
    return run


@pytest.fixture(scope="module")
def nf_runs(tmp_path_factory):
    """Both NF trainers, 2 epochs from the same init params on one fixture:
    (root, {side: (trainer, stdout lines)})."""
    root = tmp_path_factory.mktemp("nf")
    make_sid_fixture(root, n_scenes=3, H=32, W=48)
    mp = pytest.MonkeyPatch()
    out, cwd = {}, os.getcwd()
    try:
        for side in ("torch", "jax"):
            os.makedirs(root / side, exist_ok=True)
            os.chdir(root / side)
            path = _write(root / f"{side}.yml", _nf_runfile(root, side))
            lines = []
            for mod in (jax_nf, __import__("pnnp_tpu_torch.trainer_nf", fromlist=["x"])):
                mp.setattr(mod, "log", lambda s, *a, **k: lines.append(str(s)))
            if side == "torch":
                t = NFTrainer(path, model_kind="proxy", device="cpu")
                init = params_to_jax(t.model.state_dict())
            else:
                # the port's init params instead of a flax init (the eager
                # init compiles the whole sampler: ~10 s on this CPU)
                mp.setattr(JProxy, "init", lambda self, *a, **k: {"params": init})
                t = jax_nf.NFTrainer(path, mode="train", model_kind="proxy")
                t.mesh, t.train_step = None, t._base_train_step  # one device
                t.state = jax.device_put(t.state, jax.devices()[0])
            t.train()
            out[side] = (t, lines, init)
    finally:
        os.chdir(cwd)
        mp.undo()
    return root, out


def test_nf_trainer_matches_jax(nf_runs):
    root, out = nf_runs
    (tt, tlines, init), (jt, jlines, _) = out["torch"], out["jax"]
    for lines in (tlines, jlines):
        assert [e for e, _ in NF_LINE.findall("\n".join(lines))] == ["1", "2"]
        assert [m[0] for m in KLD_LINE.findall("\n".join(lines))] == ["2"]
    for (_, a), (_, b) in zip(NF_LINE.findall("\n".join(tlines)),
                              NF_LINE.findall("\n".join(jlines))):
        assert abs(float(a) - float(b)) <= 2e-4
    for d in ("checkpoints", "saved_model"):
        assert sorted(os.listdir(root / "torch" / d)) == sorted(os.listdir(root / "jax" / d))
    last = "checkpoints/NF_Proxy_last_model.ckpt"
    got, ref = load_any(str(root / "torch" / last)), jax_load_any(str(root / "jax" / last))
    assert got["meta"]["epoch"] == ref["meta"]["epoch"] == 2
    assert np.isfinite(got["meta"]["eval_psnr"]) and got["meta"]["eval_psnr"] <= 0
    _trees_close(got["params"], ref["params"])
    moved = max(float(np.abs(np.asarray(a) - b).max()) for a, b in
                zip(jax.tree.leaves(got["params"]), jax.tree.leaves(init)))
    assert moved > 1e-4
    # sampling after training, from either package's weights
    noise = tt.sample_noise(torch.Generator().manual_seed(0), torch.full((1, 4, 8, 8), 0.01),
                            torch.full((1,), 1600.0))
    assert torch.isfinite(noise).all()


def test_nf_trainer_refuses_what_it_cannot_train(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    make_sid_fixture(tmp_path, n_scenes=2, H=32, W=48)
    run = _nf_runfile(tmp_path, "t")
    with pytest.raises(NotImplementedError, match="ROADMAP 1.12"):
        NFTrainer(_write(tmp_path / "a.yml", dict(run, arch={"name": "NoiseFlow"})),
                  device="cpu")
    run["dst_train"]["dataset"] = "Proxy_Dataset"  # lr == hr: no residual
    t = NFTrainer(_write(tmp_path / "b.yml", run), model_kind="proxy", device="cpu")
    with pytest.raises(RuntimeError, match="yields lr == hr"):
        t.train()
    # the CLI's default kind trains a pw_iso arch as the proxy
    run["dst_train"]["dataset"] = "SID_Dataset"
    run["hyper"]["stop_epoch"] = 1
    t = nf_main(["-f", _write(tmp_path / "c.yml", run)], device="cpu")
    assert t.kind == "proxy" and np.isfinite(t.nll_meter.avg)
    assert os.path.exists(t.ckpt.last_path())


# --------------------------------------------------- Proxy_Dataset training
def _pnnp_run(root, mode, **extra):
    """A PNNP.yml-style runfile (Proxy_Dataset + arch_proxy) on the fixture."""
    run = make_sid_runfile(root, "PNNP_Unet", nf=4, patch_size=16, H=64, W=96,
                           batch_size=1, stop_epoch=2)
    run["mode"] = mode
    run["dst_train"]["dataset"] = "Proxy_Dataset"
    run["arch_proxy"] = dict(PROXY_ARCH)
    run["dst_eval"]["ratio_list"] = [250]
    run["hyper"].update(plot_freq=1, T=2)
    run.update(extra)
    return run


def _count_samples(monkeypatch):
    calls, sample = [], PixelWiseISOProxy.sample

    def counted(self, clean, iso, generator):
        calls.append((tuple(clean.shape), float(iso.reshape(-1)[0])))
        return sample(self, clean, iso, generator)

    monkeypatch.setattr(PixelWiseISOProxy, "sample", counted)
    return calls


def test_trainonly_with_a_jax_proxy_checkpoint(nf_runs, tmp_path, monkeypatch, capsys):
    root, _ = nf_runs
    ckpt = str(root / "jax" / "checkpoints" / "NF_Proxy_last_model.ckpt")
    make_sid_fixture(tmp_path, n_scenes=2, H=64, W=96)
    monkeypatch.chdir(tmp_path)
    calls = _count_samples(monkeypatch)
    run = _pnnp_run(tmp_path, "trainonly", proxy_checkpoint=ckpt)
    t = Trainer(_write(tmp_path / "run.yml", run), device="cpu", nofig=True, debug=True)
    assert f"Loaded proxy checkpoint {ckpt}" in capsys.readouterr().out
    _trees_close(params_to_jax(t.proxy.state_dict()), jax_load_any(ckpt)["params"],
                 rtol=0, atol=0)
    assert not any(p.requires_grad for p in t.proxy.parameters())
    before = params_to_jax(t.model.state_dict())
    t.train()
    out = capsys.readouterr().out
    assert "aborted" not in out
    # 2 scenes x 2 epochs, one sample per step, the Sony law
    assert len(calls) == 4 and all(s == (2, 4, 16, 16) for s, _ in calls)
    assert all(iso in LEGAL_ISO for _, iso in calls)
    after = params_to_jax(t.model.state_dict())
    assert all(np.isfinite(v).all() for p in after.values() for v in p.values())
    assert max(float(np.abs(after[n][k] - before[n][k]).max())
               for n in before for k in before[n]) > 1e-4
    # the proxy is not trained by the denoiser's step
    _trees_close(params_to_jax(t.proxy.state_dict()), jax_load_any(ckpt)["params"],
                 rtol=0, atol=0)


def test_pnnp_train_mode_runs_into_evaltest(tmp_path, monkeypatch, capsys):
    """PNNP.yml has no proxy_checkpoint: a fresh proxy from flax's init law."""
    infos = make_sid_fixture(tmp_path, n_scenes=2, H=64, W=96)
    place_eval_split(tmp_path, infos, 250)
    monkeypatch.chdir(tmp_path)
    calls = _count_samples(monkeypatch)
    t = trainer_main(["-f", _write(tmp_path / "run.yml", _pnnp_run(tmp_path, "train")),
                      "--mode", "train", "--nofig"], device="cpu")
    out = capsys.readouterr().out
    assert "aborted" not in out and "Loaded proxy checkpoint" not in out
    assert len(calls) == 4
    # an eval leg per epoch, then the evaltest sweep
    assert [len(re.findall(f"Epoch {e}: PSNR=", out)) for e in (1, 2, -1)] == [1, 1, 1]
    fresh = PixelWiseISOProxy(generator=torch.Generator().manual_seed(0), d=D, nf=NF, nb=NB)
    _trees_close(params_to_jax(t.proxy.state_dict()), params_to_jax(fresh.state_dict()),
                 rtol=0, atol=0)


def test_proxy_families_need_their_parts(tmp_path, monkeypatch):
    make_sid_fixture(tmp_path, n_scenes=2, H=64, W=96)
    monkeypatch.chdir(tmp_path)
    run = _pnnp_run(tmp_path, "train")
    del run["arch_proxy"]
    with pytest.raises(RuntimeError, match="requires a proxy network"):
        Trainer(_write(tmp_path / "a.yml", run), device="cpu")
    run = _pnnp_run(tmp_path, "train")
    run["dst_train"]["dataset"] = "NF_Syn_Dataset"
    with pytest.raises(NotImplementedError, match="ROADMAP 1.12"):
        Trainer(_write(tmp_path / "b.yml", run), device="cpu")
    # eval modes build no proxy
    t = Trainer(_write(tmp_path / "c.yml", _pnnp_run(tmp_path, "eval")), device="cpu")
    assert t.proxy is None


def test_validate_proxy_tool_runs(capsys):
    from pnnp_tpu_torch.tools.validate_proxy import main

    got = main(["--cpu", "--steps", "20", "--d", "64", "--patch", "16", "--batch", "2",
                "--eval-frames", "2"])
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(last) == json.loads(json.dumps(got))
    assert got["metric"] == "proxy_iso_ladder" and np.isfinite(got["nll"])
    assert got["device"] == "cpu"
    rows = got["rows"]
    assert [r["iso"] for r in rows] == [800, 1600, 3200, 12800, 6400]
    assert [r["heldout"] for r in rows] == [False] * 4 + [True]
    assert all(np.isfinite(r[k]) for r in rows for k in ("kld", "kld_floor", "row_kld"))


def test_ladder_spread_over_seeds_and_a_given_init(tmp_path, capsys):
    """Seed 0 is the tool's own run; a params pickle of the same init draw
    (JAX layout) gives the same rows; another seed another run."""
    from pnnp_tpu_torch.tools.ladder_spread import TEST_BARS, main
    from pnnp_tpu_torch.tools.validate_proxy import main as ladder

    args = ["--cpu", "--steps", "3", "--d", "16", "--patch", "8", "--batch", "2",
            "--eval-frames", "1"]
    got = main(["--seeds", "0,1"] + args)
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == json.loads(
        json.dumps(got))
    plain = ladder(args)["rows"]
    runs = got["runs"]
    assert [r["seed"] for r in runs] == [0, 1]
    assert [{k: v for k, v in r.items() if k != "inside"} for r in runs[0]["rows"]] == plain
    assert runs[1]["rows"] != runs[0]["rows"]
    for i, r in enumerate(plain):
        s = got["spread"][r["iso"]]
        assert s["kld_min"] <= s["kld_median"] <= s["kld_max"]
        kld, row = TEST_BARS[r["heldout"]]
        assert s["inside"] == sum(run["rows"][i]["kld"] <= kld and run["rows"][i]["row_kld"] <= row
                                  for run in runs)
    init = tmp_path / "init.pkl"
    proxy = PixelWiseISOProxy(d=16, nf=16, nb=2, generator=torch.Generator().manual_seed(0))
    with open(init, "wb") as f:
        pickle.dump(params_to_jax(proxy.state_dict()), f)
    again = main(["--seeds", "0", "--init-from", str(init)] + args)
    assert again["runs"][0]["rows"] == runs[0]["rows"]
