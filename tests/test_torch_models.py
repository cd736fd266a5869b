"""UNetSeeInDark in the PyTorch port against the flax module.

Same weights (a JAX parameter tree through ``params_from_jax``), same
inputs (numpy, seeded): the f32 forwards agree to rtol 1e-4 / atol 1e-5,
the tolerance of tests/test_models.py's torch oracle (f32 convolutions
summed in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pnnp_tpu.models import UNetSeeInDark as FlaxUNet
from pnnp_tpu.models import flax_to_torch_state as jax_flax_to_torch
from pnnp_tpu_torch.models import (
    UNetSeeInDark,
    build_model,
    flax_to_torch_state,
    params_from_jax,
    params_to_jax,
    torch_state_to_flax,
)


def jax_unet_params(nf: int = 4, seed: int = 0, std: float = 0.1,
                    head_bias: float | None = None) -> dict:
    """A flax UNetSeeInDark parameter tree of seeded numpy normals.

    Shapes come from ``jax.eval_shape`` of the flax init (tracing only: an
    eager flax init compiles every op and takes tens of seconds on the CPU).
    ``std`` 0.1 is 5x the N(0, 0.02) init, so that a mis-mapped tap (e.g.
    an unflipped ConvTranspose) cannot hide below a tolerance. ``head_bias``
    sets ``conv10_1``'s bias: 0.3 puts a random net's output on [0.2, 0.4]
    for inputs on [0, 0.4], inside the eval's [0, 1] clip."""
    shapes = jax.eval_shape(
        FlaxUNet(nf=nf).init, jax.random.key(0),
        jax.ShapeDtypeStruct((1, 16, 16, 4), jnp.float32))["params"]
    rng = np.random.default_rng(seed)
    params = jax.tree.map(
        lambda s: (rng.standard_normal(s.shape) * std).astype(np.float32), shapes)
    if head_bias is not None:
        params["conv10_1"]["bias"] = np.full_like(params["conv10_1"]["bias"], head_bias)
    return params


@pytest.fixture(scope="module")
def flax_unet():
    return FlaxUNet(nf=4), jax_unet_params()


@pytest.mark.parametrize("res", [False, True])
def test_f32_forward_matches_flax(flax_unet, res):
    model, params = flax_unet
    x = np.random.default_rng(0).standard_normal((2, 32, 48, 4)).astype(np.float32)
    ref = np.asarray(FlaxUNet(nf=4, res=res).apply({"params": params}, jnp.asarray(x)))
    net = UNetSeeInDark(nf=4, res=res)
    net.load_state_dict(params_from_jax(params), strict=True)
    with torch.no_grad():
        got = net(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5)


def test_jax_package_export_loads_strict(flax_unet):
    """The JAX package's own flax_to_torch_state output (a reference .pth
    state_dict) loads into the port with strict=True, unconverted."""
    _, params = flax_unet
    state = {k: torch.from_numpy(np.ascontiguousarray(v))
             for k, v in jax_flax_to_torch(params).items()}
    net = UNetSeeInDark(nf=4)
    net.load_state_dict(state, strict=True)
    np.testing.assert_array_equal(net.upv6.weight.detach().numpy(),
                                  jax_flax_to_torch(params)["upv6.weight"])


def test_converter_copies_match_jax_package(flax_unet):
    """The port's numpy copies of the converters give the JAX package's
    arrays, and params_to_jax inverts params_from_jax."""
    from pnnp_tpu.models import torch_state_to_flax as jax_torch_to_flax

    _, params = flax_unet
    ours, theirs = flax_to_torch_state(params), jax_flax_to_torch(params)
    assert ours.keys() == theirs.keys()
    for k in ours:
        np.testing.assert_array_equal(ours[k], theirs[k])
    back = params_to_jax(params_from_jax(params))
    ref = jax_torch_to_flax(theirs)
    for name in params:
        for leaf in params[name]:
            np.testing.assert_array_equal(back[name][leaf], params[name][leaf])
            np.testing.assert_array_equal(
                torch_state_to_flax(ours)[name][leaf], ref[name][leaf])


def test_init_is_seeded_normal_002():
    """N(0, 0.02) conv weights and biases, zero ConvTranspose bias, drawn
    from the generator passed in (same seed, same weights)."""
    a = UNetSeeInDark(nf=8, generator=torch.Generator().manual_seed(3))
    b = UNetSeeInDark(nf=8, generator=torch.Generator().manual_seed(3))
    for (n, p), q in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(p, q), n
    w = a.conv5_1.weight.detach()
    assert abs(float(w.std()) - 0.02) < 1e-3 and abs(float(w.mean())) < 1e-3
    assert float(a.upv6.weight.detach().std()) == pytest.approx(0.02, abs=1e-3)
    assert float(a.upv6.bias.detach().abs().max()) == 0.0
    assert float(a.conv1_1.bias.detach().abs().max()) > 0.0


def test_registry_dtype_and_unported_arches():
    m = build_model({"name": "UNetSeeInDark", "nf": 4}, dtype=torch.bfloat16)
    assert m.conv1_1.weight.dtype == torch.bfloat16
    y = m(torch.zeros(1, 4, 16, 16))
    assert y.dtype == torch.float32 and y.shape == (1, 4, 16, 16)
    assert build_model({"name": "UNetSeeInDark", "nf": 4,
                        "dtype": "bf16"}).dtype == torch.bfloat16
    with pytest.raises(KeyError, match="ROADMAP 1.13"):
        build_model({"name": "ResUnet", "nf": 4})
    with pytest.raises(KeyError, match="unknown arch"):
        build_model({"name": "NoSuchNet"})
