"""The int8 serving tools of the port (``pnnp_tpu_torch/tools/``:
``ablate_int8_quantset``, ``profile_prefix_int8``, ``bench_int8``,
``int8_roofline``) against the JAX tools, on the CPU at their ``--small``
sizes.

* ``ablate_int8_quantset``: the same subsets as the JAX tool's ``SUBSETS``;
  each subset's forward (``subset_forward``) on JAX's transformed weights
  and scales, in f32, within 1e-3 of the norm of JAX's forward with the
  same subset quantized (tests/test_torch_int8.py's int8 bar: codes flip
  where f32 rounding moves an activation across a rounding boundary); the
  JSON lines carry the JAX tool's keys.
* ``profile_prefix_int8``: the JAX tool's seven prefix names, in order;
  the full prefix bit-equal to the W8A8 forward that ``--int8`` serves;
  each shorter prefix the band's output of that forward.
* ``bench_int8``: the JAX tool's case names and JSON keys.
* ``int8_roofline``: the FLOP inventory derived from the walk's recorded
  layer shapes equal, exactly, to the JAX tool's table
  (tools/int8_roofline.py, evaluated from its source) at the small and the
  Sony frame; the port's copy of the table equal to it too; the JSON keys,
  band names and the int4 probe's JSON form.

The JAX tools run only on a TPU or through jit compiles that take minutes
here, so their names, keys and table are read from their sources (``ast``).
"""

import ast
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pnnp_tpu.models.unet_s2d_int8 as JI
from pnnp_tpu.models.unet_s2d import transform_params_hybrid as jax_transform
from pnnp_tpu_torch.models.unet_s2d_int8 import (
    BANDS,
    calibrate_act_scales,
    quantize_params_int8,
    unet_hybrid_forward_packed_int8,
)
from pnnp_tpu_torch.tools import ablate_int8_quantset as AQ
from pnnp_tpu_torch.tools import bench_int8 as BI
from pnnp_tpu_torch.tools import int8_roofline as IR
from pnnp_tpu_torch.tools import profile_prefix_int8 as PP
from tests.test_torch_int8 import NF, _port_tparams, nhwc, packed, rel
from tests.test_torch_models import jax_unet_params

TOOLS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools")
INT8_REL = 1e-3  # tests/test_torch_int8.py::test_int8_forward_matches_jax


def _source(name):
    with open(os.path.join(TOOLS, name)) as f:
        return ast.parse(f.read())


def _assigned(tree, target):
    """The value node of the first ``target = ...`` in ``tree``."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == target for t in node.targets):
            return node.value
    raise KeyError(target)


def _jax_table(H2, W2):
    """tools/int8_roofline.py's ``bands`` list, evaluated from its source."""
    px1 = H2 * W2
    ns = dict(px1=px1, px2=px1 // 4, px3=px1 // 16, px4=px1 // 64,
              conv=lambda px, cin, cout: px * 9 * cin * cout * 2,
              upT=lambda px_out, cin, cout: px_out * cin * cout * 2)
    node = _assigned(_source("int8_roofline.py"), "bands")
    return eval(compile(ast.Expression(node), "int8_roofline.py", "eval"), ns)


def _json_keys(tree, call_name="dumps"):
    """The key sets of every dict literal passed to a ``.<call_name>(...)``
    call (``json.dumps``, ``out.append``)."""
    out = []
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                and node.func.attr == call_name and node.args
                and isinstance(node.args[0], ast.Dict)):
            out.append({k.value for k in node.args[0].keys})
    return out


@pytest.fixture(scope="module")
def shared():
    params = jax_unet_params(NF, seed=5, std=0.1)
    g1 = (np.random.default_rng(1).uniform(0, 1, (1, 32, 48, 16)) * 0.5).astype(np.float32)
    jtp = jax_transform(params, jnp.float32)
    jscales = JI.calibrate_act_scales(jtp, [jnp.asarray(g1)], jnp.float32, pct=99.95)
    return jtp, jscales, g1


def test_subsets_match_jax_tool():
    import tools.ablate_int8_quantset as JA

    assert {k: tuple(v) for k, v in AQ.SUBSETS.items()} == \
        {k: tuple(v) for k, v in JA.SUBSETS.items()}
    assert list(AQ.SUBSETS) == list(JA.SUBSETS)


@pytest.mark.parametrize("name", list(AQ.SUBSETS))
def test_subset_forward_matches_jax(shared, name):
    jtp, jscales, g1 = shared
    subset = AQ.SUBSETS[name]
    if subset:
        jqp = JI.quantize_params_int8(jtp, jscales, quant=subset)
        want = np.asarray(JI.unet_hybrid_forward_packed_int8(jtp, jqp, jnp.asarray(g1), jnp.float32))
    else:
        want = np.asarray(JI.unet_hybrid_forward_packed_ref(jtp, jnp.asarray(g1), jnp.float32))
    scales = {k: float(v) for k, v in jscales.items()}
    fwd = AQ.subset_forward(_port_tparams(jtp), scales, subset, torch.float32)
    with torch.no_grad():
        got = nhwc(fwd(packed(g1)))
    assert got.shape == want.shape
    assert rel(got, want) <= INT8_REL, (name, rel(got, want))


def test_ablate_json_lines(capsys):
    rows = AQ.main(["bf16", "all", "--small", "--cpu", "--frames", "1", "--repeats", "1"])
    lines = [json.loads(s) for s in capsys.readouterr().out.strip().splitlines()]
    assert lines == rows and [r["subset"] for r in rows] == ["bf16", "all"]
    (want,) = _json_keys(_source("ablate_int8_quantset.py"))
    for r in rows:
        assert set(r) == want and r["ms_frame"] > 0


def test_prefixes_are_the_int8_forward():
    """Prefix i is the walk cut after band i of the same forward; the full
    prefix is the served W8A8 forward, bit for bit."""
    assert list(PP.NAMES) == [e.value for e in _assigned(_source("profile_prefix_int8.py"),
                                                          "names").elts]
    assert len(BANDS) == len(PP.NAMES)
    tp = AQ.make_tparams(torch.device("cpu"))
    g = torch.rand(AQ.SMALL_FRAME, generator=torch.Generator().manual_seed(1)) * 0.3
    qp = quantize_params_int8(tp, calibrate_act_scales(tp, [g], pct=99.95))
    with torch.no_grad():
        full = unet_hybrid_forward_packed_int8(tp, qp, g)
        assert torch.equal(PP.prefix_fn(tp, qp, len(BANDS) - 1)(g), full)
        widths = [PP.prefix_fn(tp, qp, n)(g).shape[1] for n in range(len(BANDS) - 1)]
    assert widths == [32, 64, 128, 512, 128, 64]  # p1, c2, c3, c5, c7, c8 at nf=32


def test_profile_prefix_rows():
    rows = PP.main(["--small", "--cpu", "--iters", "1", "--repeats", "1"])
    assert [n for n, _ in rows] == list(PP.NAMES)
    assert all(t > 0 for _, t in rows)


def test_bench_int8_cases_and_keys(capsys):
    tree = _source("bench_int8.py")
    cases = [n.elts[0].value for n in ast.walk(tree)
             if isinstance(n, ast.Tuple) and n.elts and isinstance(n.elts[0], ast.Constant)
             and str(n.elts[0].value).startswith(("conv3x3_", "matmul_"))]
    small = {c for c in cases if c.endswith("@64x64") or "_4k_" in c}
    assert [c for c, _, _ in BI.SMALL_CASES] == [c for c in cases if c in small]
    assert [c for c, _, _ in BI.CASES] == [c for c in cases if c not in small]
    full_keys = max(_json_keys(tree), key=len)
    rows = BI.main(["--small", "--cpu"])
    assert [r["case"] for r in rows] == [c for c, _, _ in BI.SMALL_CASES]
    for r in rows:
        assert set(r) == full_keys and r["bf16_ms"] > 0 and r["int8_ms"] > 0


@pytest.mark.parametrize("H2,W2", [(64, 64), (712, 1064)])
def test_roofline_table_is_the_jax_table(H2, W2):
    want = _jax_table(H2, W2)
    assert IR.reference_bands(H2, W2) == want
    assert [b for b, _ in want] == list(BANDS)


def test_roofline_inventory_from_the_walk():
    """The walk's recorded shapes give the JAX table's FLOPs, per band and
    shape class, exactly (at 64x64 and at a non-square frame)."""
    tp = AQ.make_tparams(torch.device("cpu"))
    for H2, W2 in ((64, 64), (64, 96)):
        got = IR.inventory(tp, torch.zeros((1, 16, H2, W2)))
        assert got == IR.by_class(_jax_table(H2, W2))
    shapes = IR.layer_shapes(tp, torch.zeros(AQ.SMALL_FRAME))
    assert set(shapes) == {n for names in IR.BAND_LAYERS.values() for n in names}


def test_roofline_json(capsys):
    out = IR.main(["--small", "--cpu", "--iters", "1", "--probe-int4"])
    tail = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(tail) == {"metric", "bands", "int4"} and tail["metric"] == "int8_roofline"
    assert [b["band"] for b in tail["bands"]] == list(BANDS) and tail["bands"] == out
    keys = [k for k in _json_keys(_source("int8_roofline.py"), "append") if "band" in k]
    assert all(set(b) == keys[0] for b in out)
    assert tail["int4"] == {"error": IR.NO_INT4}
