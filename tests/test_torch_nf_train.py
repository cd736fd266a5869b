"""NoiseFlow's training half against the JAX package's: the NF step,
``NFTrainer --kind noise_flow``, the ``NF_Syn`` synth, the ``NF.yml``
recipes and ``tools/validate_nf.py``.

* ``make_nf_train_step`` against JAX's on the same init weights and paired
  batches, after 1 and 3 steps: the reported ``nll``/``sd_z`` (rtol 1e-5),
  params and ``batch_stats`` at the denoiser's f32 step tolerance (rtol
  1e-4 / atol 1e-5). Two kinds of leaf are held to a bound instead: the biases of
  the convolutions before each BatchNorm have an exactly zero gradient in
  train mode (the batch mean removes them), so each package's Adam moves
  them by at most lr per step on f32 noise, in directions of its own; and
  the running means, which see those biases, by at most (1 - 0.99) times
  that drift.
* ``NFTrainer --kind noise_flow`` for 3 epochs on a tiny SID fixture
  against the JAX ``NFTrainer`` from the same init (one device): the epoch
  NLL lines (within 2e-3), every epoch's checkpoint scored by the held-out
  KLD and ``best`` the min-KLD epoch (tests/test_phone_and_nf.py:126-175),
  ``batch_stats`` saved and moved; the last checkpoint loads in JAX.
* The ``NF_Syn`` synth of both cameras on a JAX ``NoiseFlow`` checkpoint:
  the drawn noise is the JAX flow's inverse of a shared ``z`` (the port's
  own forward of the draw; 1e-4 of the largest), that ``z`` is N(0, 1) by
  moments, and the noise's moments equal JAX's synth's (2%).
* ``SonyA7S2/NF.yml`` and ``IMX686/NF.yml`` ``--mode train`` at nf=4 on
  the tiny fixtures: every step's noise from NoiseFlow, finite losses.
* ``tools/validate_nf.py`` at a tiny budget: its JSON line and rows; the
  reduced budget of tests/test_nf_kld_parity.py with its bars (``slow``).
"""

import json
import math
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

import pnnp_tpu.trainer as jax_trainer
import pnnp_tpu.trainer_nf as jax_nf
import pnnp_tpu_torch.trainer as T
from pnnp_tpu.models.noise_flow import NoiseFlow as JNoiseFlow
from pnnp_tpu.train.checkpoint import load_any as jax_load_any
from pnnp_tpu.train.state import TrainState, make_adam_direction
from pnnp_tpu_torch.data.fixtures import make_sid_fixture, make_sid_runfile
from pnnp_tpu_torch.models import NoiseFlow, flow_params_to_jax
from pnnp_tpu_torch.train import TrainStep, load_any, make_adam, save_checkpoint
from pnnp_tpu_torch.trainer_nf import NFTrainer, make_nf_train_step
from tests.test_torch_families import fixtures, tiny_runfile  # noqa: F401  (fixture)

ARCH = "sdn|unc|unc|unc|unc|giso|unc|unc|unc|unc"
SPAN = 16383.0 - 512.0
NF_LINE = re.compile(r"Epoch (\d+): nll/dim=(\S+) \(\S+s\)")
PRE_BN = ("conv2d_1", "conv2d_2")  # convolutions whose output a BatchNorm normalizes


def _paired(k, n=2, h=16, w=16, seed=0):
    """(lr, hr, ratio, iso) NHWC: dark clean signal, noise of a few ADU."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(k):
        ratio = rng.uniform(100, 300, n).astype(np.float32)
        hr = rng.uniform(0, 0.05, (n, h, w, 4)).astype(np.float32)
        noise = (rng.normal(0, 4, (n, h, w, 4)) + rng.normal(0, 1, (n, h, 1, 4))) / SPAN
        lr = (hr + noise * ratio[:, None, None, None]).astype(np.float32)
        out.append((lr, hr, ratio, np.array([800.0, 3200.0][:n], np.float32)))
    return out


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


def _hold(got, ref, init, steps, lr, stats=False):
    """Leaves equal at rtol 1e-4 / atol 1e-5, but the pre-BatchNorm biases
    (within lr * steps of their init in both) and, in ``batch_stats``, the
    running means (within 0.01 * 2 * lr * steps of each other)."""
    got, ref, init = _leaves(got), _leaves(ref), _leaves(init)
    assert got.keys() == ref.keys()
    for k in ref:
        if not stats and any(f"'{c}']['bias']" in k for c in PRE_BN):
            for side in (got, ref):
                assert np.abs(side[k] - init[k]).max() <= lr * steps * (1 + 1e-3), k
        elif stats and k.endswith("['mean']"):
            np.testing.assert_allclose(got[k], ref[k], rtol=0, atol=1e-5 + 0.02 * lr * steps,
                                       err_msg=k)
        else:
            np.testing.assert_allclose(got[k], ref[k], rtol=1e-4, atol=1e-5, err_msg=k)


# ------------------------------------------------------------------ the step
def test_nf_step_matches_jax():
    lr_fn = lambda e: 1e-3 * (1 + e)
    tf = NoiseFlow(ARCH, generator=torch.Generator().manual_seed(4))
    params, stats = flow_params_to_jax(tf.state_dict())
    init = (params, stats)
    state = TrainState.create(apply_fn=None, params=jax.tree.map(jnp.asarray, params),
                              tx=make_adam_direction(),
                              batch_stats=jax.tree.map(jnp.asarray, stats))
    jstep = jax_nf.make_nf_train_step(JNoiseFlow(x_shape=(16, 16, 4), arch=ARCH), lr_fn)
    opt = make_adam(tf.parameters())
    tstep = make_nf_train_step(tf, lr_fn)
    for i, (lr, hr, ratio, iso) in enumerate(_paired(3)):
        state, jm = jstep(state, jnp.asarray(lr), jnp.asarray(hr), jnp.asarray(ratio),
                          jnp.asarray(iso), i)
        tm = tstep(opt, _nchw(lr), _nchw(hr), torch.from_numpy(ratio), torch.from_numpy(iso), i)
        for k in ("nll", "sd_z"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5, err_msg=k)
        assert tm["lr"] == pytest.approx(float(jm["lr"]))
        if i in (0, 2):
            got_p, got_s = flow_params_to_jax(tf.state_dict())
            _hold(got_p, state.params, init[0], i + 1, max(lr_fn(j) for j in range(i + 1)))
            _hold(got_s, state.batch_stats, init[1], i + 1, lr_fn(i), stats=True)
    # the step trained: the couplings' last convolutions and the ISO tables moved
    got_p, got_s = flow_params_to_jax(tf.state_dict())
    assert np.abs(got_p["unc_1"]["net"]["conv2d_3"]["kernel"]).max() > 1e-3
    assert np.abs(got_p["giso_5"]["cam_param"]).max() > 1e-3
    assert np.abs(got_s["unc_9"]["net"]["bn1"]["var"] - 1.0).max() > 1e-3
    # the reported nll is the plain one plus mean(log ratio)
    lr, hr, ratio, iso = _paired(1, seed=5)[0]
    nll, _ = tf.loss(_nchw((lr - hr) / ratio[:, None, None, None]),
                     clean=_nchw(hr / ratio[:, None, None, None]), iso=torch.from_numpy(iso),
                     train=True)
    m = make_nf_train_step(tf, lambda e: 0.0)(make_adam(tf.parameters()), _nchw(lr), _nchw(hr),
                                              torch.from_numpy(ratio), torch.from_numpy(iso), 1)
    assert float(m["nll"]) == pytest.approx(float(nll) + float(np.log(ratio).mean()), rel=1e-5)


# --------------------------------------------------------------- the trainer
def _nf_run(root, side):
    run = make_sid_runfile(root, "NF_Flow", patch_size=8, H=32, W=48, batch_size=1,
                           stop_epoch=3)
    run.update(arch={"name": "NoiseFlow", "arch": ARCH, "flow_permutation": 1},
               checkpoint=str(root / side / "saved_model"),
               fast_ckpt=str(root / side / "checkpoints"), num_workers=0)
    run["dst_train"]["dataset"] = "SID_Dataset"
    # plot_freq 2 leaves epochs 1 and 3 off the logging grid: still scored
    run["hyper"].update(plot_freq=2, save_freq=1)
    path = root / f"{side}.yml"
    with open(path, "w") as f:
        yaml.safe_dump(run, f)
    return str(path)


@pytest.fixture(scope="module")
def nf_runs(tmp_path_factory):
    """Both NF trainers (noise_flow kind), 3 epochs from the port's init on
    one fixture: {side: (trainer, log lines, scores by epoch)}, init trees."""
    root = tmp_path_factory.mktemp("nf_flow")
    make_sid_fixture(root, n_scenes=3, H=32, W=48)
    mp = pytest.MonkeyPatch()
    out, cwd = {}, os.getcwd()
    try:
        for side in ("torch", "jax"):
            os.makedirs(root / side, exist_ok=True)
            os.chdir(root / side)
            path = _nf_run(root, side)
            lines = []
            for mod in (jax_nf, __import__("pnnp_tpu_torch.trainer_nf", fromlist=["x"])):
                mp.setattr(mod, "log", lambda s, *a, **k: lines.append(str(s)))
            if side == "torch":
                t = NFTrainer(path, device="cpu")
                init = flow_params_to_jax(t.model.state_dict())
            else:
                # the port's init trees instead of an eager flax init
                mp.setattr(JNoiseFlow, "init",
                           lambda self, *a, **k: {"params": init[0], "batch_stats": init[1]})
                t = jax_nf.NFTrainer(path, mode="train")
                t.mesh, t.train_step = None, t._base_train_step  # one device
                t.state = jax.device_put(t.state, jax.devices()[0])
            scores, save = {}, t.ckpt.save

            def spy(epoch, params, batch_stats=None, eval_psnr=None, _s=scores, _save=save):
                _s[epoch] = eval_psnr
                return _save(epoch, params, batch_stats, eval_psnr=eval_psnr)
            t.ckpt.save = spy
            t.train()
            out[side] = (t, lines, scores)
    finally:
        os.chdir(cwd)
        mp.undo()
    return root, out, init


def test_nf_trainer_matches_jax(nf_runs):
    root, out, init = nf_runs
    (tt, tlines, tscores), (jt, jlines, jscores) = out["torch"], out["jax"]
    assert tt.kind == jt.kind == "noise_flow"
    for lines in (tlines, jlines):
        assert [e for e, _ in NF_LINE.findall("\n".join(lines))] == ["1", "2", "3"]
        assert len(re.findall(r"Epoch 2: KLD fwd=", "\n".join(lines))) == 1
    for (_, a), (_, b) in zip(NF_LINE.findall("\n".join(tlines)),
                              NF_LINE.findall("\n".join(jlines))):
        assert abs(float(a) - float(b)) <= 2e-3, (a, b)
    for d in ("checkpoints", "saved_model"):
        assert sorted(os.listdir(root / "torch" / d)) == sorted(os.listdir(root / "jax" / d))
    got = load_any(str(root / "torch" / "checkpoints" / "NF_Flow_last_model.ckpt"))
    ref = jax_load_any(str(root / "jax" / "checkpoints" / "NF_Flow_last_model.ckpt"))
    assert got["meta"]["epoch"] == ref["meta"]["epoch"] == 3
    # 6 steps at the fixed 1e-3: the pre-BN biases drift apart on f32 noise
    _hold(got["params"], ref["params"], init[0], 6, 1e-3)
    _hold(got["batch_stats"], ref["batch_stats"], init[1], 6, 1e-3, stats=True)
    moved = np.abs(got["batch_stats"]["unc_1"]["net"]["bn2"]["var"] - 1.0).max()
    assert moved > 1e-3


def test_nf_trainer_scores_every_checkpoint(nf_runs):
    """Every saved epoch carries the held-out KLD score and ``best`` is the
    min-KLD epoch, in both packages; the checkpoints carry batch_stats."""
    root, out, _ = nf_runs
    for side in ("torch", "jax"):
        t, _, scores = out[side]
        assert set(scores) == {1, 2, 3}
        assert all(s is not None and np.isfinite(s) and s <= 0 for s in scores.values())
        best = (load_any if side == "torch" else jax_load_any)(t.ckpt.best_path())
        assert best["meta"]["eval_psnr"] == max(scores.values())
        assert best["meta"]["epoch"] == max(scores, key=scores.get)
        assert best["batch_stats"]["unc_1"]["net"]["bn1"]["var"].shape == (4,)
    # the port's checkpoint samples in JAX
    ck = jax_load_any(str(root / "torch" / "checkpoints" / "NF_Flow_last_model.ckpt"))
    jf = JNoiseFlow(x_shape=(8, 8, 4), arch=ARCH)
    noise = jf.apply({"params": ck["params"], "batch_stats": ck["batch_stats"]},
                     jax.random.key(0), clean=jnp.full((1, 8, 8, 4), 0.01), iso=1600.0,
                     method=jf.sample)
    assert np.isfinite(np.asarray(noise)).all()


# ------------------------------------------------------------- NF_Syn synth
def _flow_checkpoint(path, seed=11):
    """A JAX-layout NoiseFlow checkpoint off its init (trained-like weights)."""
    tf = NoiseFlow(ARCH, generator=torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for name, p in tf.named_parameters():
            if name.endswith(("conv2d_3.weight", "conv2d_3.bias")):
                p.copy_(torch.from_numpy(rng.normal(0, 0.05, p.shape).astype(np.float32)))
            if name.endswith("cam_param"):
                p.copy_(torch.from_numpy(rng.normal(0, 0.1, p.shape).astype(np.float32)))
    params, stats = flow_params_to_jax(tf.state_dict())
    save_checkpoint(str(path), params, stats, meta={"epoch": 1})
    return tf


@pytest.mark.parametrize("camera", ["SonyA7S2", "IMX686"])
def test_nf_syn_synth_matches_jax(tmp_path, camera):
    imx = camera == "IMX686"
    name = "IMX686_NF_Syn_Dataset" if imx else "NF_Syn_Dataset"
    ck = tmp_path / "nf.ckpt"
    tf = _flow_checkpoint(ck)
    dst = {"camera_type": camera, "noise_code": "p" if imx else "pgrq", "ori": False,
           "clip": False, "wp": 1023 if imx else 16383, "bl": 64 if imx else 512,
           "patch_size": 8}
    # the port's Trainer with only what _init_proxy / _make_synth read
    pt = T.Trainer.__new__(T.Trainer)
    pt.args, pt.dst, pt.device = {"proxy_checkpoint": str(ck)}, dst, torch.device("cpu")
    pt.dst_train, pt.training, pt.proxy = {"dataset": name}, True, None
    pt._init_proxy({"name": "NoiseFlow", "arch": ARCH, "flow_permutation": 1})
    assert isinstance(pt.proxy, NoiseFlow) and not pt.proxy.training
    assert not any(p.requires_grad for p in pt.proxy.parameters())
    tsynth = pt._make_synth()
    assert set(pt.synth_keys) == {"hr", "iso"}
    isos, sample = [], pt.proxy.sample
    pt.proxy.sample = lambda clean, iso, g: (isos.append(iso.clone()), sample(clean, iso, g))[1]
    # the JAX Trainer's synth on the same checkpoint
    loaded = jax_load_any(str(ck))
    jt = jax_trainer.Trainer.__new__(jax_trainer.Trainer)
    jt.args, jt.mode, jt.dst, jt._use_packed = {"dst_train": {"dataset": name}}, "train", dst, False
    jt.proxy = JNoiseFlow(x_shape=(8, 8, 4), arch=ARCH)
    jt.proxy_vars = {"params": loaded["params"], "batch_stats": loaded["batch_stats"]}
    jsynth = jt._make_synth()

    n = 64
    hr = np.random.default_rng(3).uniform(0.0, 0.3, (n, 8, 8, 4)).astype(np.float32)
    batch = {"hr": _nchw(hr), "iso": torch.full((n,), 6400.0)}
    lr, out_hr, ratio = tsynth(torch.Generator().manual_seed(0), batch)
    assert out_hr is batch["hr"] and len(isos) == 1
    rb = ratio.reshape(-1, 1, 1, 1)
    noise, clean = (lr - out_hr) / rb, out_hr / rb
    # the draw's latent under the port's flow is N(0, 1) ...
    with torch.no_grad():
        z, _ = tf.forward(noise, clean=clean, iso=isos[0])
    assert abs(float(z.mean())) < 0.02 and abs(float(z.std()) - 1.0) < 0.02
    # ... and the JAX flow's inverse of that shared z is the draw
    ref = np.asarray(jt.proxy.apply(jt.proxy_vars, jnp.asarray(z.permute(0, 2, 3, 1).numpy()),
                                    clean=jnp.asarray(clean.permute(0, 2, 3, 1).numpy()),
                                    iso=jnp.asarray(isos[0].numpy()), method=jt.proxy.inverse))
    np.testing.assert_allclose(noise.permute(0, 2, 3, 1).numpy(), ref, rtol=1e-4,
                               atol=1e-4 * np.abs(ref).max())
    if imx:
        # one ISO (the batch's) and a dgain that only scales lr: the noise
        # laws of the two synths on this batch agree by moments
        jl, _, jr = jsynth(jax.random.key(0), {"hr": jnp.asarray(hr),
                                               "iso": jnp.full((n,), 6400.0)})
        jn = (np.asarray(jl) - hr) / np.asarray(jr)[:, None, None, None]
        tn = noise.permute(0, 2, 3, 1).numpy()
        assert float(isos[0]) == 6400.0 and set(ratio.tolist()) <= {1.0, 2.0, 4.0, 8.0, 16.0}
    else:
        # the Sony law draws its ISO per batch: compare the flows' draws at
        # one ISO, the sample each synth calls
        iso = 3200.0
        tn = pt.proxy.sample(clean, torch.full((1,), iso), torch.Generator().manual_seed(1))
        tn = tn.permute(0, 2, 3, 1).numpy()
        jn = np.asarray(jt.proxy.apply(jt.proxy_vars, jax.random.key(1),
                                       clean=jnp.asarray(clean.permute(0, 2, 3, 1).numpy()),
                                       iso=jnp.full((1,), iso), method=jt.proxy.sample))
        from pnnp_tpu_torch.physics.calibration import LEGAL_ISO

        assert float(isos[0]) in LEGAL_ISO and ((ratio >= 100) & (ratio <= 300)).all()
    assert abs(tn.std() / jn.std() - 1.0) < 0.02
    assert abs(tn.mean() - jn.mean()) < 0.02 * jn.std()


# ------------------------------------------------------------ NF.yml recipes
@pytest.mark.parametrize("rel", ["SonyA7S2/NF", "IMX686/NF"])
def test_nf_recipe_trains(fixtures, monkeypatch, rel):  # noqa: F811
    monkeypatch.chdir(fixtures)
    path, run = tiny_runfile(rel, str(fixtures))
    assert run["arch_proxy"]["name"] == "NoiseFlow" and "NF_Syn" in run["dst_train"]["dataset"]
    losses, samples = [], []
    call, sample = TrainStep.__call__, NoiseFlow.sample

    def counted(self, *a):
        m = call(self, *a)
        losses.append(float(m["loss"]))
        return m

    def sampled(self, clean, iso, generator, eps_std=None):
        samples.append(tuple(clean.shape))
        return sample(self, clean, iso, generator, eps_std)
    monkeypatch.setattr(TrainStep, "__call__", counted)
    monkeypatch.setattr(NoiseFlow, "sample", sampled)
    t = T.main(["-f", path, "--mode", "trainonly", "--nofig"], device="cpu")
    n = len(t.dataset_train)
    assert len(losses) == n and all(math.isfinite(x) for x in losses)
    assert samples == [(2, 4, 16, 16)] * n
    assert isinstance(t.proxy, NoiseFlow) and t.proxy.arch == ARCH
    assert load_any(t.ckpt.last_path())["meta"]["epoch"] == 1


# -------------------------------------------------------------- validate_nf
def test_validate_nf_tool_runs(capsys):
    from pnnp_tpu_torch.tools.validate_nf import main

    rows = main(["--steps", "6", "--chunk", "3", "--patch", "8", "--batch", "2",
                 "--eval-frames", "2"], device="cpu")
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert last["metric"] == "nf_kld_parity" and last["rows"] == rows
    assert [r["iso"] for r in rows] == [800, 1600, 3200, 12800, 6400]
    assert [r["heldout"] for r in rows] == [False] * 4 + [True]
    assert all(np.isfinite(r["kld"]) and np.isfinite(r["kld_floor"]) for r in rows)
    assert len(last["kld_traj"]) == last["n_chunks"] == 2 and 0 <= last["best_chunk"] < 2
    assert isinstance(last["ok"], bool) and np.isfinite(last["nll"])


@pytest.mark.slow
def test_nf_kld_parity_reduced_budget():
    """tests/test_nf_kld_parity.py on the port, with its bars."""
    from pnnp_tpu_torch.tools.validate_nf import main

    rows = main(["--steps", "4000", "--patch", "16", "--batch", "4", "--eval-frames", "8"],
                device="cpu")
    by_iso = {r["iso"]: r for r in rows}
    for iso, bar in {800: 0.08, 1600: 0.06, 3200: 0.14, 12800: 0.9}.items():
        assert by_iso[iso]["kld"] <= bar, (iso, by_iso[iso])
    assert by_iso[6400]["heldout"] and by_iso[6400]["kld"] > 0.3
