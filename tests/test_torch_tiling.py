"""Halo tiling and ``Trainer.predict`` in the port against the JAX package.

The tile ops move data only: they must equal JAX's exactly. ``predict``
(pack, tiles, the f32 forward in chunks of 4 tiles, merge) is held to rtol
1e-4 / atol 1e-5 of JAX ``Trainer.predict`` on shared f32 weights
(``disable_fast_path: true`` in both runfiles).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

import pnnp_tpu.trainer as jax_trainer
from pnnp_tpu.ops import tiling as J
from pnnp_tpu_torch.data.fixtures import make_sid_fixture, make_sid_runfile
from pnnp_tpu_torch.ops import tiling as T
from pnnp_tpu_torch.train.checkpoint import save_checkpoint
from pnnp_tpu_torch.trainer import Trainer
from tests.test_torch_models import jax_unet_params
from tests.test_torch_trainer import _shape_only_state

# (H, W, patch, base): a frame on the grid, one with end-anchored strips,
# and the trainer's default tiling of a small frame
CASES = [(96, 144, 64, 16), (101, 77, 40, 8), (480, 500, 512, 64)]


@pytest.mark.parametrize("size,patch,stride", [(100, 64, 48), (1424, 64, 48), (448, 512, 448),
                                               (449, 512, 448), (1424, 512, 448),
                                               (2128, 512, 448)])
def test_tile_starts_match_jax(size, patch, stride):
    np.testing.assert_array_equal(T._tile_starts(size, patch, stride),
                                  J._tile_starts(size, patch, stride))


@pytest.mark.parametrize("H,W,patch,base", CASES)
def test_crop_and_merge_match_jax(H, W, patch, base):
    data = np.random.default_rng(H).uniform(0, 1, (H, W, 4)).astype(np.float32)
    tiles = T.eval_crop(torch.from_numpy(data), patch, base)
    ref = np.asarray(J.eval_crop(jnp.asarray(data), patch, base))
    np.testing.assert_array_equal(tiles.numpy(), ref)
    # merge of distinct per-tile values: the write order decides the overlaps
    marked = ref * 0 + np.arange(ref.shape[0], dtype=np.float32)[:, None, None, None] + ref
    np.testing.assert_array_equal(T.eval_merge(torch.from_numpy(marked), (H, W), base).numpy(),
                                  np.asarray(J.eval_merge(jnp.asarray(marked), (H, W), base)))
    # identity round trip
    np.testing.assert_array_equal(T.eval_merge(tiles, (H, W), base).numpy(), data)


@pytest.mark.parametrize("tile_batch", [0, 4, 5])
def test_tiled_apply_matches_jax(tile_batch):
    H, W, patch, base = CASES[1]
    data = np.random.default_rng(1).uniform(0, 1, (H, W, 4)).astype(np.float32)
    calls = []

    def fn_t(x):
        calls.append(x.shape[0])
        return torch.flip(x, dims=(-1,)) * 2.0 + x.mean(dim=(1, 2, 3), keepdim=True)

    got = T.tiled_apply(fn_t, torch.from_numpy(data), patch, base, tile_batch=tile_batch)
    ref = J.tiled_apply(lambda x: jnp.flip(x, -1) * 2.0 + x.mean(axis=(1, 2, 3), keepdims=True),
                        jnp.asarray(data), patch, base, tile_batch=tile_batch)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-6)
    n = len(T._tile_starts(H, patch, patch - base)) * len(T._tile_starts(W, patch, patch - base))
    assert sum(calls) == n and max(calls) == (tile_batch or n)


def test_eval_crop_refuses_small_frames():
    with pytest.raises(ValueError, match="smaller than the tile stride"):
        T.eval_crop(torch.zeros((40, 600, 4)), 512, 64)


def test_predict_matches_jax(tmp_path, monkeypatch):
    """A 160x224 mosaic in 64^2 tiles (halo 8): 6 tiles, fed 4 + 2 here and
    4 + 4 (zero-padded) in JAX; ``{name}.npy`` written by both."""
    monkeypatch.setattr(jax_trainer, "create_train_state", _shape_only_state)
    make_sid_fixture(tmp_path, n_scenes=2, H=32, W=48)
    run = dict(make_sid_runfile(tmp_path, "PRED_Unet", nf=4), mode="eval",
               disable_fast_path=True)
    save_checkpoint(os.path.join(run["fast_ckpt"], "PRED_Unet_best_model.ckpt"),
                    jax_unet_params(4, seed=21, head_bias=0.3), meta={"epoch": 1})
    path = str(tmp_path / "run.yml")
    with open(path, "w") as f:
        yaml.safe_dump(run, f)
    raw = np.random.default_rng(2).uniform(0, 3000, (160, 224)).astype(np.float32)

    monkeypatch.chdir(tmp_path)
    jt = jax_trainer.Trainer(path, mode="eval", nofig=True, debug=True)
    ref = jt.predict(raw, name="jax_pred", patch_size=64, base=16)
    pt = Trainer(path, mode="eval", nofig=True, debug=True, device="cpu")
    assert pt.model.conv1_1.weight.dtype == torch.float32
    got = pt.predict(raw, name="torch_pred", patch_size=64, base=16)
    assert got.shape == ref.shape == (80, 112, 4)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(np.load(tmp_path / "torch_pred.npy"), got)
    assert os.path.exists(tmp_path / "jax_pred.npy")
