"""The recipe A/B (``pnnp_tpu_torch/tools/ab_proxy_vs_physics.py``) against
the JAX tool (``tools/ab_proxy_vs_physics.py``), on the CPU.

The pieces are held exactly where they are deterministic: the scene
generator (bit-identical for one ``np.random.Generator`` state), the per-ISO
calibration rows, the ladder proxy synth's arithmetic. The random streams
cannot be shared across packages; their structure is held instead: both
arms draw one index stream, the null control's arm B its own noise. A
tiny-budget run (real and ``--null``) prints the JAX tool's JSON keys and
resumes from ``--state-dir``; the ``slow`` mirror of
tests/test_ab_recipe.py holds the reduced budget to that test's bars.
"""

import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pnnp_tpu.train as jax_train
import pnnp_tpu_torch.tools.ab_proxy_vs_physics as ab
from pnnp_tpu.physics.calibration import ISO_TABLES
from pnnp_tpu_torch.tools.demo_train import synthetic_scenes
from tests.test_torch_trainer import _shape_only_state
from tools.demo_train import synthetic_scenes as jax_synthetic_scenes

TINY = ["--proxy-steps", "4", "--unet-steps", "4", "--patch", "32", "--batch", "2",
        "--chunk", "2", "--pool", "4", "--eval-frames", "2", "--nf", "4", "--d", "16", "--cpu"]
ROW_KEYS = {"iso", "ratio", "input_psnr", "physics_psnr", "proxy_psnr", "delta", "heldout_iso"}


@pytest.mark.parametrize("seed,n,p", [(1997, 3, 32), (31337, 2, 17), (0, 1, 64)])
def test_synthetic_scenes_bit_identical(seed, n, p):
    a = synthetic_scenes(np.random.default_rng(seed), n, p)
    b = jax_synthetic_scenes(np.random.default_rng(seed), n, p)
    assert a.dtype == b.dtype == np.float32 and a.shape == (n, p, p, 4)
    np.testing.assert_array_equal(a, b)


def test_iso_table_rows_match_jax():
    t = ISO_TABLES["SonyA7S2"]
    got = ab.iso_table(ab.AB_ISOS)
    for j, iso in enumerate(ab.AB_ISOS):
        i = int(np.where(t["iso"] == iso)[0][0])
        for k in ab.TABLE_KEYS:
            assert got[k][j] == float(t[k][i]), (iso, k)
    assert (got["q"], got["wp"], got["bl"]) == (float(t["q"]), float(t["wp"]), float(t["bl"]))
    rows = ab.table_rows(got, "cpu")
    p = ab.noise_params(rows, torch.tensor([2]), 3, 150.0)
    assert torch.equal(p["K"], torch.full((3,), float(t["Kmax"][np.where(t["iso"] == 3200)[0][0]])))
    assert torch.equal(p["ratio"], torch.full((3,), 150.0))


def test_ladder_proxy_synth_arithmetic():
    """A fixed-noise sample_fn: lr == hr + noise * ratio, the ISO one of the
    ladder's, one per batch, the ratio per example in [100, 300]."""
    iso_arr = torch.tensor(ab.AB_ISOS, dtype=torch.float32)
    fixed = torch.from_numpy(np.random.default_rng(3).normal(0, 1e-3, (4, 4, 6, 5))
                             .astype(np.float32))
    seen = []

    def sample_fn(generator, clean, iso):
        seen.append((clean.clone(), iso.clone()))
        return fixed

    synth = ab.ladder_proxy_synth(sample_fn, iso_arr)
    hr = torch.from_numpy(np.random.default_rng(4).uniform(0, 1, (4, 4, 6, 5)).astype(np.float32))
    for s in range(20):
        lr, hr_out, ratio = synth(torch.Generator().manual_seed(s), {"hr": hr})
        assert hr_out is hr and ratio.shape == (4,)
        assert bool(((ratio >= 100) & (ratio <= 300)).all())
        torch.testing.assert_close(lr, hr + fixed * ratio.reshape(-1, 1, 1, 1), rtol=0, atol=0)
        clean, iso = seen[-1]
        torch.testing.assert_close(clean, hr / ratio.reshape(-1, 1, 1, 1), rtol=0, atol=0)
        assert iso.shape == (1,) and float(iso) in ab.AB_ISOS
    assert len({float(i) for _, i in seen}) > 2  # the draw moves over the ladder


def test_physics_synth_draws_the_ladder():
    """One ladder ISO per batch and ratio ~ U(100, 300): replaying the
    generator's draws gives the same pgrq frame through generate_noisy."""
    from pnnp_tpu_torch.physics.noise import generate_noisy

    rows = ab.table_rows(ab.iso_table(), "cpu")
    hr = torch.from_numpy(np.random.default_rng(5).uniform(0, 0.2, (3, 4, 8, 8)).astype(np.float32))
    lr, _, ratio = ab.physics_synth(rows)(torch.Generator().manual_seed(9), {"hr": hr})
    g = torch.Generator().manual_seed(9)
    idx = torch.randint(len(ab.AB_ISOS), (1,), generator=g)
    r = torch.rand(3, generator=g) * 200.0 + 100.0
    ref = generate_noisy(g, hr, ab.noise_params(rows, idx, 3, r), "pgrq", ori=False)
    torch.testing.assert_close(ratio, r, rtol=0, atol=0)
    torch.testing.assert_close(lr, ref, rtol=0, atol=0)


def test_null_arm_shares_the_index_stream_not_the_noise():
    for at in (0, 500):
        ia, na = ab.arm_generators("cpu", at, null_b=False)
        ib, nb = ab.arm_generators("cpu", at, null_b=True)
        draw = lambda g: torch.randint(64, (8,), generator=g)
        assert torch.equal(draw(ia), draw(ib))
        assert not torch.equal(torch.rand(16, generator=na), torch.rand(16, generator=nb))
    # the real A/B's arms draw one noise stream; chunks differ from each other
    _, n0 = ab.arm_generators("cpu", 0)
    _, n0b = ab.arm_generators("cpu", 0)
    i0, _ = ab.arm_generators("cpu", 0)
    i1, _ = ab.arm_generators("cpu", 2)
    assert torch.equal(torch.rand(4, generator=n0), torch.rand(4, generator=n0b))
    assert not torch.equal(torch.randint(64, (8,), generator=i0),
                           torch.randint(64, (8,), generator=i1))


def _json_line(out: str) -> dict:
    return json.loads([ln for ln in out.splitlines() if ln.startswith("{")][-1])


@pytest.fixture(scope="module")
def jax_json():
    """The JAX tool's JSON line at zero steps (its keys; no training)."""
    import io
    from contextlib import redirect_stdout

    from tools.ab_proxy_vs_physics import main as jax_ab

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_train, "create_train_state", _shape_only_state)
        buf = io.StringIO()
        with redirect_stdout(buf):
            jax_ab(["--proxy-steps", "0", "--unet-steps", "0", "--patch", "32",
                    "--eval-frames", "1", "--nf", "4", "--d", "16", "--cpu", "--null"])
    return _json_line(buf.getvalue())


@pytest.mark.parametrize("null", [False, True])
def test_tiny_run_prints_the_jax_keys(jax_json, capsys, tmp_path, null):
    argv = TINY + (["--null"] if null else ["--proxy-ckpt", str(tmp_path / "proxy.pkl")])
    rows = ab.main(argv)
    got = _json_line(capsys.readouterr().out)
    assert set(got) == set(jax_json) == {"metric", "mean_delta_db", "worst_delta_db", "ok", "rows"}
    assert got["metric"] == ("ab_null_control" if null else "ab_proxy_vs_physics")
    assert [set(r) for r in got["rows"]] == [set(r) for r in jax_json["rows"]] \
        == [ROW_KEYS] * 8
    assert [(r["iso"], r["ratio"], r["heldout_iso"]) for r in got["rows"]] \
        == [(r["iso"], r["ratio"], r["heldout_iso"]) for r in jax_json["rows"]]
    assert got["rows"] == rows
    assert all(math.isfinite(r[k]) for r in rows for k in ROW_KEYS - {"heldout_iso"})
    if not null:  # the proxy checkpoint is the JAX param tree: it loads in JAX
        import pickle

        from pnnp_tpu.models import PixelWiseISOProxy

        with open(tmp_path / "proxy.pkl", "rb") as f:
            tree = pickle.load(f)
        shapes = jax.eval_shape(PixelWiseISOProxy(d=16, nf=16, nb=2).init,
                                {"params": jax.random.key(0), "sample": jax.random.key(1)},
                                jnp.zeros((1, 8, 8, 4)), jnp.full((1,), 1600.0))["params"]
        assert jax.tree.map(np.shape, tree) == jax.tree.map(lambda s: s.shape, shapes)
        capsys.readouterr()
        assert ab.main(argv) == rows  # the second run loads the checkpoint
        assert f"[proxy] loaded {tmp_path / 'proxy.pkl'}" in capsys.readouterr().err


def test_state_dir_resumes(tmp_path, capsys, monkeypatch):
    """A run cut after its first chunk and resumed from the snapshot prints
    what an uninterrupted run prints."""
    argv = TINY + ["--null", "--state-dir", str(tmp_path / "state")]
    real = ab.arm_generators

    def cut(device, at, null_b=False):
        if at > 0:
            raise KeyboardInterrupt("cut after the first chunk")
        return real(device, at, null_b)

    monkeypatch.setattr(ab, "arm_generators", cut)
    with pytest.raises(KeyboardInterrupt):
        ab.main(argv)
    monkeypatch.setattr(ab, "arm_generators", real)
    capsys.readouterr()
    resumed = ab.main(argv)
    err = capsys.readouterr().err
    assert "[physics] resumed at step 2" in err and "physics2] resumed" not in err
    assert resumed == ab.main(TINY + ["--null"])


@pytest.mark.slow
def test_ab_harness_reduced_budget():
    """tests/test_ab_recipe.py's budget and bars."""
    rows = ab.main([
        "--proxy-steps", "600", "--unet-steps", "150", "--patch", "64",
        "--batch", "2", "--chunk", "75", "--pool", "16",
        "--eval-frames", "4", "--nf", "8", "--d", "64", "--cpu",
    ])
    assert len(rows) == 8
    assert any(r["heldout_iso"] for r in rows)
    for r in rows:
        for k in ("input_psnr", "physics_psnr", "proxy_psnr", "delta"):
            assert math.isfinite(r[k]), r
    deltas = [r["delta"] for r in rows]
    assert abs(sum(deltas) / len(deltas)) <= 0.3, rows
    assert min(deltas) >= -0.6, rows
    noisy = [r for r in rows if r["ratio"] == 300 and r["iso"] >= 6400]
    assert noisy
    for r in noisy:
        assert r["physics_psnr"] >= r["input_psnr"] + 4.0, r
        assert r["proxy_psnr"] >= r["input_psnr"] + 4.0, r
