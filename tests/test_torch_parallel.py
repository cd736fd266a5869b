"""Several ranks on ``torch.distributed`` (``pnnp_tpu_torch/parallel``)
against one rank and against the JAX package.

Two ``gloo`` ranks on the CPU, started with the ``spawn`` method (the test
process holds JAX's threads), rendezvous through a file store in the test's
own directory, each spawn joined within its own time limit. The rank
workers are the functions of this module, which imports no JAX at its top:
the spawned children import it by name.

* The data-parallel train step (UNetSeeInDark nf=4, f32, identity synth,
  8 x 16^2, 3 steps) against the one-rank step on the whole batch: loss
  rtol 1e-5, params rtol 1e-4 / atol 1e-6 (the JAX package's own bar,
  tests/test_parity_and_sharding.py:65-97), and the two ranks' params equal.
* The data-parallel NoiseFlow step (3 steps, 4 crops whose halves differ
  in noise level) against the one-rank step: the reported nll rtol 1e-5,
  params and ``batch_stats`` at tests/test_torch_nf_train.py's bars (the
  pre-BatchNorm biases, whose gradient is exactly zero, bounded by Adam's
  step instead). The same run with the BatchNorm moments left local
  differs from the one-rank step, so the comparison can fail.
* The width-sharded fused eval at nsp = 2 against the single-device fused
  step, at JAX's shapes (``(128, 1664)`` aligned, with and without the
  input panel, and ``(122, 1700)`` misaligned), from the host-packed input
  too, through the W8A8 forward (``qparams``, the ``--int8`` path), and the
  narrow-frame fallback, at tests/test_sharded_fused_eval.py's
  bars: frame atol 5e-3, PSNR 1e-3, SSIM 1e-5; ``spatial_eval`` with
  ``halo = 0`` and ``spatial_eval_auto`` against the whole-frame forward.
* The same step in bf16 against JAX's ``make_eval_metrics_step_sharded``
  on conftest's virtual CPU mesh (nsp = 2), unpacked and host-packed, at
  the bars of tests/test_torch_eval_step.py (both serve bf16 but round at
  other places): PSNR 1e-2 dB, SSIM 1e-3, frame atol 2**-6.
* ``Trainer`` under two ranks on a fixture wide enough to shard: ``--mode
  eval`` (the sharded fused step) and with ``disable_fused_eval`` (the
  sharded unfused forward) agree with the one-rank eval per frame (PSNR
  1e-3, SSIM 1e-5); ``--mode trainonly`` and ``trainer_nf --kind
  noise_flow`` for one epoch run data-parallel, each rank loading its half
  of every batch, and end with the same params (and running stats) on both
  ranks; one metrics pickle, one log and the checkpoints, written by rank 0
  alone.
"""

import faulthandler
import os
import pickle
import time

import multiprocessing as mp
import numpy as np
import pytest
import torch
import torch.distributed as dist
import yaml

SPAWN_TIMEOUT = 60.0  # seconds per spawn, all ranks
NF = 4
TRAIN_LR = 1e-3
FLOW_ARCH = "sdn|unc|unc|unc|unc|giso|unc|unc|unc|unc"
SPAN = 16383.0 - 512.0
PRE_BN = ("conv2d_1", "conv2d_2")
EVAL_TOL = dict(frame=5e-3, psnr=1e-3, ssim=1e-5)
BF16_TOL = dict(frame=2**-6, psnr=1e-2, ssim=1e-3)
HALO = 96


# ------------------------------------------------------------------ spawning
def _rank_entry(fn_name, rank, world, store, out, args):
    # the rank's stderr goes to its own file, for _spawn's messages; a rank
    # still running near the limit dumps every thread's stack there
    err = open(os.path.join(out, f"rank{rank}.err"), "w")
    os.dup2(err.fileno(), 2)
    faulthandler.dump_traceback_later(SPAWN_TIMEOUT - 5.0, exit=False)
    os.environ["OMP_NUM_THREADS"] = "1"
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=world)
    try:
        result = globals()[fn_name](rank, *args)
        torch.save(result, os.path.join(out, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _rank_report(procs, out, tail=4000):
    """Each rank's exit code (None: still running) and the end of its
    stderr."""
    lines = []
    for r, p in enumerate(procs):
        path = os.path.join(out, f"rank{r}.err")
        text = ""
        if os.path.exists(path):
            with open(path, errors="replace") as f:
                text = f.read()[-tail:]
        lines.append(f"--- rank {r}: exit code {p.exitcode}\n{text}")
    return "\n".join(lines)


def _spawn(tmp_path, fn_name, *args, world=2):
    """Run ``fn_name(rank, *args)`` on ``world`` gloo ranks; their results.
    A failure names every rank's exit code and the end of its stderr."""
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_entry,
                         args=(fn_name, r, world, str(tmp_path / "store"), str(tmp_path), args))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + SPAWN_TIMEOUT
    for p in procs:
        p.join(max(deadline - time.monotonic(), 0.0))
    hung = [p for p in procs if p.is_alive()]
    report = _rank_report(procs, str(tmp_path))
    for p in hung:
        p.kill()
        p.join()
    assert not hung, (f"{fn_name}: {len(hung)} rank(s) still running after "
                      f"{SPAWN_TIMEOUT} s\n{report}")
    assert [p.exitcode for p in procs] == [0] * world, f"{fn_name}: exit codes\n{report}"
    return [torch.load(tmp_path / f"rank{r}.pt", weights_only=False) for r in range(world)]


# ------------------------------------------------------------ train steps
def _train_setup():
    from pnnp_tpu_torch.models import UNetSeeInDark
    from pnnp_tpu_torch.train import identity_synth, make_adam, make_train_step

    net = UNetSeeInDark(nf=NF, generator=torch.Generator().manual_seed(0))
    step = make_train_step(lambda e: TRAIN_LR, identity_synth, clip_mode=2)
    return net, make_adam(net.parameters()), step


def _train_batches(k):
    rng = np.random.default_rng(3)
    out = []
    for _ in range(k):
        hr = rng.uniform(0, 0.5, (8, 4, 16, 16)).astype(np.float32)
        lr = (hr + rng.normal(0, 0.05, hr.shape)).astype(np.float32)
        out.append({"lr": torch.from_numpy(lr), "hr": torch.from_numpy(hr),
                    "ratio": torch.ones(8)})
    return out


def _train_run(mesh=None, steps=3):
    from pnnp_tpu_torch.parallel import make_sharded_train_step, shard_batch

    net, opt, step = _train_setup()
    if mesh is not None:
        step = make_sharded_train_step(mesh, step)
    losses = []
    for b in _train_batches(steps):
        if mesh is not None:
            b = shard_batch(mesh, b)
        m = step(net, opt, b, torch.Generator().manual_seed(0), 1)
        losses.append(float(m["loss"]))
    return {"loss": losses, "state": {k: v.clone() for k, v in net.state_dict().items()}}


def _train_worker(rank):
    from pnnp_tpu_torch.parallel import make_mesh

    mesh = make_mesh()
    assert mesh.shape == {"data": 2, "spatial": 1} and mesh.data_rank == rank
    return _train_run(mesh)


def test_data_parallel_train_step_matches_one_rank(tmp_path):
    ref = _train_run()
    ranks = _spawn(tmp_path, "_train_worker")
    for got in ranks:
        np.testing.assert_allclose(got["loss"], ref["loss"], rtol=1e-5)
        for k, v in ref["state"].items():
            np.testing.assert_allclose(got["state"][k].numpy(), v.numpy(), rtol=1e-4,
                                       atol=1e-6, err_msg=k)
    for k in ref["state"]:
        assert torch.equal(ranks[0]["state"][k], ranks[1]["state"][k]), k
    moved = max(float((ranks[0]["state"][k] - v).abs().max())
                for k, v in _train_setup()[0].state_dict().items())
    assert moved > 0.5 * TRAIN_LR


# ---------------------------------------------------------- NoiseFlow step
def _flow_batches(k, n=4, h=16, w=16):
    """(lr, hr, ratio, iso) NCHW; the second half of each batch 3x noisier,
    so that the halves' BatchNorm moments differ."""
    rng = np.random.default_rng(0)
    out = []
    for _ in range(k):
        ratio = rng.uniform(100, 300, n).astype(np.float32)
        hr = rng.uniform(0, 0.05, (n, 4, h, w)).astype(np.float32)
        level = np.repeat([4.0, 12.0], n // 2)[:, None, None, None]
        noise = (rng.normal(0, 1, hr.shape) * level + rng.normal(0, 1, (n, 4, h, 1))) / SPAN
        lr = (hr + noise * ratio[:, None, None, None]).astype(np.float32)
        iso = np.repeat([800.0, 3200.0], n // 2).astype(np.float32)
        out.append(tuple(torch.from_numpy(a) for a in (lr, hr, ratio, iso)))
    return out


def _flow_lr(epoch):
    return 1e-3 * (1 + epoch)


def _flow_model():
    """NoiseFlow at its seeded init, the couplings' conditioners moved off
    it (seeded): the first convolution large enough that its BatchNorm sees
    a variance above its eps on noise of a few ADU, the zero-init output
    convolution nonzero, so that the batch moments shape the NLL."""
    from pnnp_tpu_torch.models import NoiseFlow
    from pnnp_tpu_torch.models.flows.coupling import ShiftAndLogScale

    flow = NoiseFlow(FLOW_ARCH, generator=torch.Generator().manual_seed(4))
    g = torch.Generator().manual_seed(9)
    with torch.no_grad():
        for m in flow.modules():
            if isinstance(m, ShiftAndLogScale):
                for conv, std in ((m.conv2d_1, 300.0), (m.conv2d_2, 0.5), (m.conv2d_3, 1e-4)):
                    conv.weight.normal_(0.0, std, generator=g)
    return flow


def _flow_run(mesh=None, local_moments=False):
    from pnnp_tpu_torch.models import flow_params_to_jax
    from pnnp_tpu_torch.parallel import make_sharded_noise_step, shard_batch
    from pnnp_tpu_torch.train import make_adam
    from pnnp_tpu_torch.trainer_nf import make_nf_train_step

    flow = _flow_model()
    opt = make_adam(flow.parameters())
    step = make_nf_train_step(flow, _flow_lr)
    if mesh is not None:
        step = make_sharded_noise_step(mesh, step)
    if local_moments:  # the trap: each rank's BatchNorm sees its half alone
        for m in flow.modules():
            if hasattr(type(m), "data_mean"):
                m.data_mean = None
    nll = []
    for i, batch in enumerate(_flow_batches(3)):
        if mesh is not None:
            batch = shard_batch(mesh, batch)
        nll.append(float(step(opt, *batch, i)["nll"]))
    params, stats = flow_params_to_jax(flow.state_dict())
    return {"nll": nll, "params": params, "stats": stats}


def _flow_worker(rank):
    from pnnp_tpu_torch.parallel import make_mesh

    mesh = make_mesh()
    return {"global": _flow_run(mesh), "local": _flow_run(mesh, local_moments=True)}


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _flow_gap(got, ref, init, steps=3, lr=_flow_lr(2)):
    """Assert tests/test_torch_nf_train.py's bars; returns the largest
    difference of the leaves held to f32 equality."""
    worst = 0.0
    for tree in ("params", "stats"):
        g, r, i0 = _leaves(got[tree]), _leaves(ref[tree]), _leaves(init[tree])
        assert g.keys() == r.keys()
        for k in r:
            if tree == "params" and any(f"{c}/bias" in k for c in PRE_BN):
                for side in (g, r):
                    assert np.abs(side[k] - i0[k]).max() <= lr * steps * (1 + 1e-3), k
            elif tree == "stats" and k.endswith("/mean"):
                np.testing.assert_allclose(g[k], r[k], rtol=0,
                                           atol=1e-5 + 0.02 * lr * steps, err_msg=k)
            else:
                worst = max(worst, float(np.abs(g[k] - r[k]).max()))
                np.testing.assert_allclose(g[k], r[k], rtol=1e-4, atol=1e-5, err_msg=k)
    return worst


def test_data_parallel_noiseflow_step_matches_one_rank(tmp_path):
    from pnnp_tpu_torch.models import flow_params_to_jax

    ref = _flow_run()
    p0, s0 = flow_params_to_jax(_flow_model().state_dict())
    init = {"params": p0, "stats": s0}
    ranks = _spawn(tmp_path, "_flow_worker")
    for got in ranks:
        np.testing.assert_allclose(got["global"]["nll"], ref["nll"], rtol=1e-5)
        _flow_gap(got["global"], ref, init)
    # the running variances moved, alike on both ranks
    var = _leaves(ranks[0]["global"]["stats"])
    assert max(float(np.abs(v - 1.0).max()) for k, v in var.items() if k.endswith("/var")) > 1e-3
    for k, v in var.items():
        np.testing.assert_array_equal(v, _leaves(ranks[1]["global"]["stats"])[k])
    # local moments: each rank's running statistics are its half's (the
    # zero-init output convolutions keep them out of the first steps' NLL)
    local = _leaves(ranks[0]["local"]["stats"])
    gap = max(float(np.abs(v - _leaves(ref["stats"])[k]).max()) for k, v in local.items()
              if k.endswith("/var"))
    assert gap > 1e-3, gap
    with pytest.raises(AssertionError):
        _flow_gap(ranks[0]["local"], ref, init)


# ------------------------------------------------------------- 2 x 2 mesh
def _mesh_worker(rank):
    from pnnp_tpu_torch.parallel import (
        average_gradients,
        make_eval_metrics_step_sharded,
        make_mesh,
        shard_batch,
    )

    mesh = make_mesh(n_data=2, n_spatial=2)
    ids = torch.tensor([float(rank)])
    col, row = ids.clone(), ids.clone()
    dist.all_reduce(col, group=mesh.data_group)  # same spatial coordinate
    dist.all_reduce(row, group=mesh.spatial_group)  # same data coordinate
    block = shard_batch(mesh, {"x": torch.arange(8), "ccm": torch.ones(3, 3)})
    p = torch.nn.Parameter(torch.zeros(3))
    p.grad = torch.full((3,), float(rank))
    average_gradients(mesh, [p])
    lr, hr = _frame(64, 640, seed=4)
    step = make_eval_metrics_step_sharded(_eval_model(), mesh, halo=HALO)
    return {"coords": (mesh.data_rank, mesh.spatial_rank), "col": float(col),
            "row": float(row), "block": block["x"].tolist(), "ccm": tuple(block["ccm"].shape),
            "grad": p.grad.tolist(), "eval": _as_numpy(step(lr, hr, 100.0, ori=True))}


def test_two_by_two_mesh(tmp_path):
    """Rank r at (r // 2, r % 2): the data groups are the columns, the
    spatial groups the rows; the data rank keeps its block of the batch
    (the [3, 3] ccm whole), gradients average down a column, and each row
    runs the sharded eval of the whole frame on its own."""
    from pnnp_tpu_torch.train import make_eval_metrics_step

    ranks = _spawn(tmp_path, "_mesh_worker", world=4)
    lr, hr = _frame(64, 640, seed=4)
    ref = _as_numpy(make_eval_metrics_step(_eval_model())(lr, hr, 100.0, ori=True))
    for r, out in enumerate(ranks):
        d, s = r // 2, r % 2
        assert out["coords"] == (d, s)
        assert out["col"] == s + (2 + s) and out["row"] == 2 * d + (2 * d + 1)
        assert out["block"] == list(range(4 * d, 4 * d + 4)) and out["ccm"] == (3, 3)
        assert out["grad"] == [(s + 2 + s) / 2] * 3
        _close(out["eval"], ref, EVAL_TOL)


# ------------------------------------------------------------ sharded eval
def _eval_model(dtype=torch.float32):
    """UNetSeeInDark nf=4 at 5x the init scale, its head biased to 0.3 (a
    random net's output inside the eval's [0, 1] clip)."""
    from pnnp_tpu_torch.models import UNetSeeInDark

    net = UNetSeeInDark(nf=NF, generator=torch.Generator().manual_seed(5))
    with torch.no_grad():
        for p in net.parameters():
            p.mul_(5.0)
        net.conv10_1.bias.fill_(0.3)
    served = UNetSeeInDark(nf=NF, dtype=dtype)
    served.load_state_dict(net.state_dict())
    return served.eval()


def _frame(H, W, seed=0):
    rng = np.random.default_rng(seed)
    lr = rng.uniform(0, 0.4, (1, H, W, 4)).astype(np.float32)
    hr = rng.uniform(0, 1.0, (1, H, W, 4)).astype(np.float32)
    hr[0, :3, :5] = 1.0  # saturated: out of the correction fit
    return torch.from_numpy(lr), torch.from_numpy(hr)


# (name, H, W, ratio, ori, with_inputs, host-packed)
EVAL_CASES = [
    ("aligned", 128, 1664, 100.0, True, False, False),
    ("aligned_inputs", 128, 1664, 100.0, True, True, False),
    ("misaligned", 122, 1700, 100.0, False, False, False),
    ("packed_inputs", 122, 1700, 100.0, True, True, True),
    ("fallback", 32, 48, 1.0, False, False, False),
    ("int8", 122, 1700, 100.0, True, False, False),
]


def _qparams(net):
    """W8A8 parameters of ``net`` calibrated on one padded frame (the
    Trainer's --int8 recipe at pct 99.95)."""
    import pnnp_tpu_torch.models.unet_s2d_int8 as i8
    from pnnp_tpu_torch.models.unet_s2d import s2d
    from pnnp_tpu_torch.train.steps import HybridParams, pad_to_multiple

    tp = HybridParams(net)()
    lr, _ = _frame(122, 1700, seed=6)
    g1 = s2d(pad_to_multiple(lr, 16)[0].permute(0, 3, 1, 2))
    return i8.quantize_params_int8(tp, i8.calibrate_act_scales(tp, [g1], net.dtype, pct=99.95))
JAX_CASE = (60, 452, 32)  # H, W, halo of the comparison with JAX (bf16)


def _as_numpy(out):
    frame = [o.numpy() for o in (out[0],) + tuple(out[2:])]
    return frame, {k: float(v) for k, v in out[1].items()}


def _sharded_call(step, lr, hr, ratio, ori, with_inputs, packed, nsp, halo):
    from pnnp_tpu_torch.models.unet_s2d import pack_frame_sharded_np

    kw = dict(ori=ori, correct=True, with_inputs=with_inputs)
    if packed:
        g, hl, hr_halo = pack_frame_sharded_np(lr.numpy(), nsp, halo=halo)
        return step(torch.from_numpy(g), hr, ratio,
                    halos=(torch.from_numpy(hl), torch.from_numpy(hr_halo)), **kw)
    return step(lr, hr, ratio, **kw)


def _eval_worker(rank):
    from pnnp_tpu_torch.parallel import (
        make_eval_metrics_step_sharded,
        make_mesh,
        spatial_eval,
        spatial_eval_auto,
    )
    from pnnp_tpu_torch.train import make_eval_step

    mesh = make_mesh(n_data=1, n_spatial=2)
    assert mesh.spatial_rank == rank and mesh.data_group is None
    net = _eval_model()
    steps = {"": make_eval_metrics_step_sharded(net, mesh, halo=HALO),
             "int8": make_eval_metrics_step_sharded(net, mesh, halo=HALO,
                                                    qparams=_qparams(net))}
    out = {}
    for name, H, W, ratio, ori, with_inputs, packed in EVAL_CASES:
        lr, hr = _frame(H, W)
        step = steps["int8" if name == "int8" else ""]
        out[name] = _as_numpy(_sharded_call(step, lr, hr, ratio, ori, with_inputs, packed,
                                            2, HALO))
    lr, _ = _frame(64, 256, seed=1)
    fwd = make_eval_step(net)
    out["spatial_halo0"] = spatial_eval(mesh, fwd, lr, halo=0).numpy()
    lr, _ = _frame(122, 1700, seed=2)
    out["spatial_auto"] = spatial_eval_auto(mesh, fwd, lr, halo=HALO).numpy()
    H, W, halo = JAX_CASE
    bf16 = make_eval_metrics_step_sharded(_eval_model(torch.bfloat16), mesh, halo=halo)
    lr, hr = _frame(H, W, seed=3)
    for packed in (False, True):
        out[f"jax_{packed}"] = _as_numpy(_sharded_call(bf16, lr, hr, 100.0, True, True,
                                                       packed, 2, halo))
    return out


@pytest.fixture(scope="module")
def sharded_eval(tmp_path_factory):
    return _spawn(tmp_path_factory.mktemp("sharded_eval"), "_eval_worker")


def _close(got, ref, tol):
    (gf, gm), (rf, rm) = got, ref
    assert len(gf) == len(rf) and gm.keys() == rm.keys()
    for a, b in zip(gf, rf):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=0, atol=tol["frame"])
    for k in rm:
        tol_k = tol["psnr"] if k.startswith("psnr") else tol["ssim"]
        assert gm[k] == pytest.approx(rm[k], abs=tol_k), k


@pytest.mark.parametrize("case", EVAL_CASES, ids=[c[0] for c in EVAL_CASES])
def test_sharded_eval_matches_single_device(sharded_eval, case):
    from pnnp_tpu_torch.train import make_eval_metrics_step

    name, H, W, ratio, ori, with_inputs, _ = case
    lr, hr = _frame(H, W)
    net = _eval_model()
    step = make_eval_metrics_step(net, qparams=_qparams(net) if name == "int8" else None)
    ref = _as_numpy(step(lr, hr, ratio, ori=ori, correct=True, with_inputs=with_inputs))
    for rank_out in sharded_eval:
        _close(rank_out[name], ref, EVAL_TOL)
    np.testing.assert_array_equal(sharded_eval[0][name][0][0], sharded_eval[1][name][0][0])


def test_spatial_eval_matches_whole_frame(sharded_eval):
    from pnnp_tpu_torch.train import make_eval_step

    fwd = make_eval_step(_eval_model())
    lr, _ = _frame(64, 256, seed=1)
    halves = [fwd(lr[:, :, :128]), fwd(lr[:, :, 128:])]
    for rank_out in sharded_eval:
        # halo 0: each half alone, then gathered
        np.testing.assert_allclose(rank_out["spatial_halo0"], torch.cat(halves, 2).numpy(),
                                   rtol=1e-5, atol=1e-6)
    # spatial_eval's contract (tests/test_spatial_eval.py): the forward of
    # the frame reflect-padded by the halo, cropped; the auto wrapper pads
    # H to %16 and W to %32 first
    lr, _ = _frame(122, 1700, seed=2)
    pad = lambda t, l, r, u, d: torch.nn.functional.pad(
        t.permute(0, 3, 1, 2), (l, r, u, d), mode="reflect").permute(0, 2, 3, 1)
    img = pad(lr, 14, 14, 3, 3)
    whole = fwd(pad(img, HALO, HALO, 0, 0))[:, 3:125, HALO + 14:HALO + 14 + 1700].numpy()
    for rank_out in sharded_eval:
        np.testing.assert_allclose(rank_out["spatial_auto"], whole, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("packed", [False, True])
def test_sharded_eval_matches_jax(sharded_eval, packed):
    import jax
    import jax.numpy as jnp

    from pnnp_tpu.models import UNetSeeInDark as FlaxUNet
    from pnnp_tpu.models.unet_s2d import pack_frame_sharded_np, transform_params_hybrid
    from pnnp_tpu.parallel import make_eval_metrics_step_sharded as jax_sharded
    from pnnp_tpu.parallel import make_mesh as jax_make_mesh
    from pnnp_tpu_torch.models import params_to_jax

    H, W, halo = JAX_CASE
    mesh = jax_make_mesh(n_data=1, n_spatial=2, devices=jax.devices()[:2])
    params = jax.tree.map(jnp.asarray, params_to_jax(_eval_model().state_dict()))
    step = jax_sharded(FlaxUNet(nf=NF), mesh, halo=halo)
    lr, hr = (jnp.asarray(t.numpy()) for t in _frame(H, W, seed=3))
    kw = dict(ori=True, correct=True, with_inputs=True)
    tp = transform_params_hybrid(params)
    if packed:
        g, hl, hr_halo = pack_frame_sharded_np(np.asarray(lr), 2, halo=halo)
        out = step(tp, jnp.asarray(g), hr, 100.0, halos=(jnp.asarray(hl), jnp.asarray(hr_halo)),
                   **kw)
    else:
        out = step(tp, lr, hr, 100.0, **kw)
    ref = ([np.asarray(out[0]), np.asarray(out[2])], {k: float(v) for k, v in out[1].items()})
    for rank_out in sharded_eval:
        _close(rank_out[f"jax_{packed}"], ref, BF16_TOL)


# ----------------------------------------------------------------- Trainer
def _trainer_runfile(root, name, mode, **extra):
    from pnnp_tpu_torch.data.fixtures import make_sid_runfile

    run = make_sid_runfile(root, "PAR_Unet", nf=NF, patch_size=16, H=64, W=384,
                           batch_size=2, noise_code="pgrq")
    run.update(mode=mode, spatial_halo=16, disable_fast_path=True, **extra)
    run["dst_eval"]["ratio_list"] = [100]
    run["hyper"].update(plot_freq=1, save_freq=1)
    path = os.path.join(root, f"{name}.yml")
    with open(path, "w") as f:
        yaml.safe_dump(run, f)
    return path


def _trainer_runfiles(root):
    """The runfiles the two ranks of :func:`_trainer_worker` read, written
    once, before the spawn: ranks that each wrote the same file could read
    it while the other rank had it truncated (an empty yaml: that rank
    raised, the other waited in a collective until the spawn's limit)."""
    from pnnp_tpu_torch.data.fixtures import make_sid_runfile

    _trainer_runfile(root, "eval", "eval")
    _trainer_runfile(root, "unfused", "eval", disable_fused_eval=True)
    _trainer_runfile(root, "train", "trainonly", stop_epoch=1)
    run = make_sid_runfile(root, "PAR_Flow", patch_size=8, H=64, W=384, batch_size=2)
    run.update(arch={"name": "NoiseFlow", "arch": FLOW_ARCH}, num_workers=0)
    run["dst_train"]["dataset"] = "SID_Dataset"
    with open(os.path.join(root, "flow.yml"), "w") as f:
        yaml.safe_dump(run, f)


def _trainer_worker(rank, root):
    import pnnp_tpu_torch.kernels.ssim as K
    from pnnp_tpu_torch.trainer import main

    os.chdir(root)
    out = {}
    for name in ("eval", "unfused"):
        t = main(["-f", os.path.join(root, f"{name}.yml"), "--nofig"], device="cpu")
        dist.barrier()  # rank 0 has written the pickle
        path = os.path.join(root, "metrics", "PAR_Unet_metrics.pkl")
        with open(path, "rb") as f:
            out[name] = pickle.load(f)
        dist.barrier()
        if rank == 0:
            os.remove(path)
        out[f"{name}_sharded"] = t.mesh_spatial is not None and (
            t._fused_eval is None or t._fused_eval.__qualname__.startswith(
                "make_eval_metrics_step_sharded"))
    K.launches = 0
    t = main(["-f", os.path.join(root, "train.yml"), "--nofig"], device="cpu")
    out["train"] = {"n_data": t.n_data, "loader_shard": t._loader_shard,
                    "psnr": t.train_psnr.avg,
                    "state": {k: v.clone() for k, v in t.model.state_dict().items()}}
    from pnnp_tpu_torch.trainer_nf import main as nf_main

    nf = nf_main(["-f", os.path.join(root, "flow.yml"), "--kind", "noise_flow"], device="cpu")
    out["flow"] = {"nll": nf.nll_meter.avg, "sharded": type(nf.train_step).__name__,
                   "state": {k: v.clone() for k, v in nf.model.state_dict().items()}}
    return out


def test_trainer_under_two_ranks(tmp_path):
    from pnnp_tpu_torch.data.fixtures import make_sid_fixture
    from pnnp_tpu_torch.models import UNetSeeInDark, params_to_jax
    from pnnp_tpu_torch.train.checkpoint import save_checkpoint
    from pnnp_tpu_torch.trainer import main

    root = str(tmp_path)
    make_sid_fixture(root, n_scenes=2, H=64, W=384)
    seeded = UNetSeeInDark(nf=NF, generator=torch.Generator().manual_seed(7))
    save_checkpoint(os.path.join(root, "checkpoints", "PAR_Unet_best_model.ckpt"),
                    params_to_jax(seeded.state_dict()), meta={"epoch": 0})
    _trainer_runfiles(root)
    ranks = _spawn(tmp_path, "_trainer_worker", root)
    logs = open(os.path.join(root, "logs", "log_PAR_Unet.log")).read()

    # the one-rank eval in this process, on the same checkpoint and frames
    cwd = os.getcwd()
    os.chdir(tmp_path)
    try:
        ref = {}
        for name, extra in (("eval", {}), ("unfused", {"disable_fused_eval": True})):
            main(["-f", _trainer_runfile(root, f"{name}1", "eval", **extra), "--nofig"],
                 device="cpu")
            with open(os.path.join(root, "metrics", "PAR_Unet_metrics.pkl"), "rb") as f:
                ref[name] = pickle.load(f)
    finally:
        os.chdir(cwd)
    for out in ranks:
        for name in ("eval", "unfused"):
            assert out[f"{name}_sharded"], name
            assert out[name].keys() == ref[name].keys() and len(ref[name]) == 2
            for frame, (p, s) in ref[name].items():
                assert out[name][frame][0] == pytest.approx(p, abs=EVAL_TOL["psnr"])
                assert out[name][frame][1] == pytest.approx(s, abs=EVAL_TOL["ssim"])
    for rank, out in enumerate(ranks):
        assert out["train"]["n_data"] == 2 and out["train"]["loader_shard"] == (rank, 2)
        assert np.isfinite(out["train"]["psnr"])
    for key in ("train", "flow"):  # params and (the flow's) running stats alike
        for k, v in ranks[0][key]["state"].items():
            assert torch.equal(v, ranks[1][key]["state"][k]), (key, k)
    assert ranks[0]["flow"]["sharded"] == "ShardedNoiseStep"
    assert np.isfinite(ranks[0]["flow"]["nll"])
    assert os.path.exists(os.path.join(root, "checkpoints", "PAR_Flow_last_model.ckpt"))
    # rank 0 alone wrote: one log line per event, the checkpoints
    assert logs.count("Epoch -1: PSNR=") == 2  # the two eval runs' summaries
    assert logs.count("Devices:\t2 (cpu, float32), mesh data x spatial 2 x 1") == 3
    assert os.path.exists(os.path.join(root, "checkpoints", "PAR_Unet_last_model.ckpt"))
