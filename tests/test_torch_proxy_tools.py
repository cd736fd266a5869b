"""The proxy research tools of the port (``pnnp_tpu_torch/tools/``:
``diagnose_proxy_fit``, ``oracle_row_deconv``, ``oracle_proxy_family``)
against the JAX tools, on the CPU.

* ``diagnose_proxy_fit`` on one JAX-layout params pickle (a seeded d=64
  ``pw_iso_2stage`` init, as ``validate_proxy --save`` writes it), at ISO
  800 and 12800: the closed-form columns (pixel model variance + s0^2,
  both heads' tail_pi / tail_b, the centred heads' means) within 1e-5
  relative of JAX's heads on the same pickle (a mean, zero after
  centring, within 1e-5 of the head's scale); the sampled columns (true
  pixel variance of 2^20 TL + quant draws, the row head's draw std) within
  2% of the JAX tool's printed columns; the row KLD within 4 sqrt(2)
  standard deviations of the JAX tool's own column over keys
  (``DIAG_KLD_STD``, stated below).
* Both oracles at a short budget (ISO 12800, d = 32, 100 Adam steps; the
  row oracle at W = 32 and a 2048-row fit batch, the family oracle at a
  4096-sample fit batch and 64 / 4 eval frames), the JAX tool run on the
  same flags in the test: every fitted std / sigR and KLD of the port
  within 4 sqrt(2) standard deviations of the JAX tool's reading (the two
  readings are independent draws of one law), with the standard deviation
  of the JAX tool's column over its own seeds at that budget
  (``ROW_SD``, ``FAMILY_SD``, stated below); and every family KLD above its
  real-vs-real floor.
* The cosine schedule of ``fit_raw`` is optax's ``cosine_decay_schedule``
  at every step (rel 1e-5: optax's is float32).

How the JAX spreads were found (on a CPU, float32):
``tools/oracle_row_deconv.py`` and ``tools/oracle_proxy_family.py`` run
at the flags above with every ``jax.random.key(s)`` of the tool shifted to
``key(s + 1000 * k)``, k = 0..4 for the row oracle and k = 0..7 for the
family oracle (k = 0 is the tool as it is): the sample std of each column
over the keys. The row oracle's contaminated KLD is dominated by a few
counts of the N(0, sigR) reference in the far integer bins, which five
keys under-sample (std 0.0044 over them): against the k = 0 fitted law,
twelve ``jax.random.normal`` reference draws alone spread it with std
0.035 (0.607 to 0.726), so that column takes 0.035. The family oracle's
row KLD is scored on the eval frames' row means; at 2 eval frames its
spread (std 0.0118 on a mean of 0.026) was as large as the column, so the
test scores 64 frames, where it is 0.0013 on a mean of 0.0087. For
``diagnose_proxy_fit``: the JAX tool's row-KLD column over six keys
``key(iso + 1000 * k)`` on this test's pickle: ISO 800 1.3710-1.3933 (std
0.0075), ISO 12800 3.8890-3.9248 (std 0.0124).
"""

import json
import pickle
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pnnp_tpu.models import PixelWiseISOProxy as JaxProxy
from pnnp_tpu.models.proxy import QuantileHead as JaxHead
from pnnp_tpu_torch.models import params_to_jax
from pnnp_tpu_torch.models.proxy import PixelWiseISOProxy
from pnnp_tpu_torch.tools import diagnose_proxy_fit as DP
from pnnp_tpu_torch.tools import oracle_proxy_family as OF
from pnnp_tpu_torch.tools import oracle_row_deconv as OR

D = 64
ISOS = (800, 12800)
DIAG_KLD_STD = {800: 0.0075, 12800: 0.0124}
ROW_ARGS = ["--cpu", "--d", "32", "--steps", "100", "--fit-batch", "2048", "--w", "32",
            "--isos", "12800"]
FAMILY_ARGS = ["--cpu", "--d", "32", "--steps", "100", "--fit-batch", "4096",
               "--eval-frames", "64", "--big-eval-frames", "4", "--isos", "12800"]
# std of each column over the JAX tool's own seeds at ROW_ARGS / FAMILY_ARGS
ROW_SD = {
    "deconv": {"ratio": 0.0037, "kld_vs_gauss": 0.0027},
    "contaminated": {"ratio": 0.0054, "kld_vs_gauss": 0.035},
}
FAMILY_SD = {"kld": 0.0003, "row_kld": 0.0013, "kld_bigN": 0.0010}


@pytest.fixture(scope="module")
def pickle_path(tmp_path_factory):
    proxy = PixelWiseISOProxy(d=D, nf=16, nb=2, generator=torch.Generator().manual_seed(3))
    path = tmp_path_factory.mktemp("proxy") / "p.pkl"
    with open(path, "wb") as f:
        pickle.dump(params_to_jax(proxy.state_dict()), f)
    return str(path)


def _jax_heads(params, iso):
    """The JAX tool's ``heads_at``: both stages' HeadParams, centred."""
    proxy = JaxProxy(d=D, nf=16, nb=2, mode="2stage+iso", smooth_s0=0.3)
    feat = proxy._iso_feat(jnp.asarray([float(iso)]))
    px = JaxHead(D, 16, 2).apply({"params": params["pixel_stage"]}, feat)
    row = JaxHead(D, 16, 2).apply({"params": params["row_stage"]}, feat)
    return JaxHead.center(px), JaxHead.center(row)


def test_diagnose_matches_jax(pickle_path, capsys):
    import tools.diagnose_proxy_fit as jax_tool

    rows = DP.main([pickle_path, "--d", str(D), "--cpu", "--isos", *map(str, ISOS)])
    out = capsys.readouterr().out
    assert json.loads(out.strip().splitlines()[-1])["rows"] == rows
    with open(pickle_path, "rb") as f:
        params = jax.tree.map(jnp.asarray, pickle.load(f))
    jax_tool.main([pickle_path, "--d", str(D), "--cpu", "--isos", *map(str, ISOS)])
    table = re.findall(r"^ +(\d+) \| +([\d.]+) +([\d.]+) +[\d.]+ \| +([\d.]+) +[\d.]+ +[\d.]+ "
                       r"+([\d.]+) \|", capsys.readouterr().out, re.M)
    assert [int(t[0]) for t in table] == list(ISOS)
    for r, (_, _, v_true, row_std, kld) in zip(rows, table):
        px, row = _jax_heads(params, r["iso"])
        want = {"px_var_model": float(JaxHead.variance(px)[0, 0]) + 0.3 ** 2,
                "px_tail_pi": float(px.tail_pi[0, 0]), "px_tail_b": float(px.tail_b[0, 0]),
                "row_tail_pi": float(row.tail_pi[0, 0]), "row_tail_b": float(row.tail_b[0, 0])}
        for k, v in want.items():
            assert r[k] == pytest.approx(v, rel=1e-5), (r["iso"], k)
        scale = {"mean_px": r["px_var_model"] ** 0.5, "mean_row": r["row_std"]}
        for k, jm in (("mean_px", JaxHead.mean(px)), ("mean_row", JaxHead.mean(row))):
            assert abs(r[k] - float(jm[0, 0])) <= 1e-5 * scale[k], (r["iso"], k)
        assert r["px_var_true"] == pytest.approx(float(v_true), rel=0.02)
        assert r["row_std"] == pytest.approx(float(row_std), rel=0.02)
        bar = 4 * np.sqrt(2) * DIAG_KLD_STD[r["iso"]]
        assert abs(r["row_kld"] - float(kld)) <= bar, (r["iso"], r["row_kld"], kld, bar)


def test_cosine_schedule_is_optax():
    """rel 1e-5: optax evaluates the schedule in float32."""
    import optax

    for steps, alpha in ((100, 1e-2), (37, 1e-3)):
        sched = optax.cosine_decay_schedule(3e-3, steps, alpha)
        for t in (0, 1, steps // 2, steps - 1, steps, steps + 5):
            assert 3e-3 * OR.cosine_factor(t, steps, alpha) == pytest.approx(
                float(sched(t)), rel=1e-5)


def _within(got, ref, sd, what):
    bar = 4 * np.sqrt(2) * sd
    assert abs(got - ref) <= bar, f"{what}: {got} against JAX {ref} (bar {bar})"


def test_row_oracle_within_jax_seed_spread(capsys):
    import tools.oracle_row_deconv as jax_tool

    rows = OR.main(ROW_ARGS)
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])["rows"] == rows
    ref = jax_tool.main(ROW_ARGS)
    assert [r["mode"] for r in rows] == [r["mode"] for r in ref] == ["deconv", "contaminated"]
    for r, j in zip(rows, ref):
        assert r["s_contam"] == pytest.approx(j["s_contam"], abs=0.01)
        assert r["sigR"] == j["sigR"]
        for k, sd in ROW_SD[r["mode"]].items():
            _within(r[k], j[k], sd, f"{r['mode']} {k}")


def test_family_oracle_within_jax_seed_spread(capsys):
    import tools.oracle_proxy_family as jax_tool

    (row,) = OF.main(FAMILY_ARGS)
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])["rows"] == [row]
    (ref,) = jax_tool.main(FAMILY_ARGS)
    assert row["iso"] == ref["iso"] == 12800
    for k, sd in FAMILY_SD.items():
        _within(row[k], ref[k], sd, k)
    assert (row["kld_floor"] < row["kld"] and row["row_floor"] < row["row_kld"]
            and row["floor_bigN"] < row["kld_bigN"])
