"""The port stands alone: no JAX, no flax, nothing of ``pnnp_tpu``; and its
entry points refuse to fall back to the CPU silently."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import yaml

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "pnnp_tpu")
# the real-data CLIs, the proxy research tools, the int8 serving tools and
# the Poisson check
SLICE11_TOOLS = ("get_dataset_infos", "golden_parity", "diagnose_proxy_fit",
                 "oracle_row_deconv", "oracle_proxy_family", "ablate_int8_quantset",
                 "profile_prefix_int8", "bench_int8", "int8_roofline", "check_poisson")
# the bf16 forward profilers, the proxy-step profilers and the serving A/Bs
SLICE12_TOOLS = ("profile_prefix", "profile_layers", "profile_ablate", "profile_proxy_step",
                 "profile_proxy_synth", "bench_halfdense", "bench_serving_variants")


def _forbidden(module: str) -> bool:
    """Exact top-level match: ``pnnp_tpu`` and ``pnnp_tpu.x`` are forbidden,
    ``pnnp_tpu_torch`` is not."""
    return module.split(".")[0] in FORBIDDEN


def _port_files():
    files = sorted((ROOT / "pnnp_tpu_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py"]


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(
                node.func, "id", None)) in ("import_module", "__import__")
                and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value)


def test_forbidden_matcher_is_exact():
    assert _forbidden("pnnp_tpu") and _forbidden("pnnp_tpu.kernels.ssim")
    assert _forbidden("jax.numpy") and _forbidden("flax.linen")
    assert not _forbidden("pnnp_tpu_torch") and not _forbidden("pnnp_tpu_torch.trainer")
    assert not _forbidden("jaxtyping_like") and not _forbidden("torch")


def test_no_forbidden_import_in_sources():
    files = _port_files()
    assert len(files) > 20 and (ROOT / "chip_smoke.py").exists()
    names = {str(p.relative_to(ROOT)) for p in files}
    assert {"pnnp_tpu_torch/data/phone.py", "pnnp_tpu_torch/data/infos.py",
            "pnnp_tpu_torch/physics/hbr.py", "pnnp_tpu_torch/models/noise_flow.py",
            "pnnp_tpu_torch/models/flows/base.py", "pnnp_tpu_torch/models/flows/sdn.py",
            "pnnp_tpu_torch/models/flows/conv1x1.py", "pnnp_tpu_torch/models/flows/coupling.py",
            "pnnp_tpu_torch/tools/validate_nf.py", "pnnp_tpu_torch/trainer_led.py",
            "pnnp_tpu_torch/ops/isp.py", "pnnp_tpu_torch/ops/tiling.py",
            "pnnp_tpu_torch/tools/ab_proxy_vs_physics.py",
            "pnnp_tpu_torch/utils/profiling.py", "pnnp_tpu_torch/models/unet_s2d.py",
            "pnnp_tpu_torch/models/unet_s2d_int8.py", "pnnp_tpu_torch/ops/int8conv.py",
            "pnnp_tpu_torch/tools/validate_int8.py", "pnnp_tpu_torch/parallel/__init__.py",
            "pnnp_tpu_torch/parallel/mesh.py", "pnnp_tpu_torch/models/blocks.py",
            "pnnp_tpu_torch/train/flow_losses.py", "pnnp_tpu_torch/data/extra.py",
            "pnnp_tpu_torch/physics/unprocess.py", "pnnp_tpu_torch/models/flows/spline.py",
            "pnnp_tpu_torch/models/flows/basic.py", "pnnp_tpu_torch/models/flows/conditional.py",
            "pnnp_tpu_torch/tools/validate_noise_model.py", "pnnp_tpu_torch/tools/eval_fullres.py",
            "pnnp_tpu_torch/tools/bench_eval_loop.py", "pnnp_tpu_torch/tools/demo_train.py",
            "pnnp_tpu_torch/tools/demo_pnnp_pipeline.py"} <= names
    assert {f"pnnp_tpu_torch/tools/{m}.py" for m in SLICE11_TOOLS + SLICE12_TOOLS} <= names
    bad = [(str(p.relative_to(ROOT)), m) for p in files for m in _imports(p)
           if _forbidden(m)]
    assert not bad, bad


def test_importing_the_port_loads_no_forbidden_module():
    code = (
        "import sys\n"
        "before = set(sys.modules)\n"
        "import pnnp_tpu_torch, pnnp_tpu_torch.trainer, pnnp_tpu_torch.kernels.ssim\n"
        "import pnnp_tpu_torch.data.fixtures, pnnp_tpu_torch.kernels.build\n"
        "import pnnp_tpu_torch.trainer_nf, pnnp_tpu_torch.tools.validate_proxy\n"
        "import pnnp_tpu_torch.data.phone, pnnp_tpu_torch.data.infos\n"
        "import pnnp_tpu_torch.physics.hbr, pnnp_tpu_torch.physics.noise\n"
        "import pnnp_tpu_torch.models.noise_flow, pnnp_tpu_torch.models.flows\n"
        "import pnnp_tpu_torch.tools.validate_nf, pnnp_tpu_torch.trainer_led\n"
        "import pnnp_tpu_torch.tools.ab_proxy_vs_physics, pnnp_tpu_torch.ops.isp\n"
        "import pnnp_tpu_torch.utils.profiling, pnnp_tpu_torch.utils.debugger\n"
        "import pnnp_tpu_torch.utils.video, pnnp_tpu_torch.parallel\n"
        "import pnnp_tpu_torch.models.blocks, pnnp_tpu_torch.train.flow_losses\n"
        "import pnnp_tpu_torch.data.extra, pnnp_tpu_torch.physics.unprocess\n"
        "import pnnp_tpu_torch.models.flows.conditional, pnnp_tpu_torch.models.flows.spline\n"
        "import pnnp_tpu_torch.tools.validate_noise_model, pnnp_tpu_torch.tools.eval_fullres\n"
        "import pnnp_tpu_torch.tools.bench_eval_loop, pnnp_tpu_torch.tools.demo_pnnp_pipeline\n"
        + "".join(f"import pnnp_tpu_torch.tools.{m}\n" for m in SLICE11_TOOLS + SLICE12_TOOLS) +
        "new = set(sys.modules) - before\n"
        "bad = sorted(m for m in new if m.split('.')[0] in %r)\n"
        "assert {'pnnp_tpu_torch.trainer', 'pnnp_tpu_torch.data.phone',\n"
        "        'pnnp_tpu_torch.physics.hbr', 'pnnp_tpu_torch.models.flows.coupling',\n"
        "        'pnnp_tpu_torch.models.flows.sdn', 'pnnp_tpu_torch.parallel.mesh'} <= new\n"
        "print('BAD', bad)\n" % (FORBIDDEN,)
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout


def test_entry_points_raise_without_cuda(tmp_path, monkeypatch):
    """No CUDA and no explicit device='cpu': the Trainer, the NF trainer and
    the CLIs raise instead of running on the host."""
    import torch

    from pnnp_tpu_torch.data.fixtures import make_sid_fixture, make_sid_runfile
    from pnnp_tpu_torch.trainer import Trainer, main
    from pnnp_tpu_torch.trainer_nf import NFTrainer
    from pnnp_tpu_torch.trainer_nf import main as nf_main
    from pnnp_tpu_torch.utils.device import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    make_sid_fixture(tmp_path, n_scenes=2, H=32, W=48)
    path = str(tmp_path / "run.yml")
    with open(path, "w") as f:
        yaml.safe_dump(dict(make_sid_runfile(tmp_path), mode="eval"), f)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["-f", path, "--mode", "eval", "--nofig"])
    nf_run = dict(make_sid_runfile(tmp_path), arch={"name": "pw_iso_2stage", "d": 16})
    nf_run["dst_train"]["dataset"] = "SID_Dataset"
    nf_path = str(tmp_path / "nf.yml")
    with open(nf_path, "w") as f:
        yaml.safe_dump(nf_run, f)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        NFTrainer(nf_path, model_kind="proxy")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        nf_main(["-f", nf_path, "--kind", "proxy"])
    flow_path = str(tmp_path / "flow.yml")
    with open(flow_path, "w") as f:
        yaml.safe_dump(dict(nf_run, arch={"name": "NoiseFlow"}), f)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        nf_main(["-f", flow_path, "--kind", "noise_flow"])
    from pnnp_tpu_torch.tools.validate_nf import main as validate_nf

    with pytest.raises(RuntimeError, match="no CUDA device"):
        validate_nf(["--steps", "1"])
    from pnnp_tpu_torch.tools.ab_proxy_vs_physics import main as ab
    from pnnp_tpu_torch.trainer_led import LEDTrainer
    from pnnp_tpu_torch.trainer_led import main as led_main

    with pytest.raises(RuntimeError, match="no CUDA device"):
        ab(["--proxy-steps", "1", "--unet-steps", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LEDTrainer(path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        led_main(["-f", path])
    from pnnp_tpu_torch.tools import (
        bench_eval_loop,
        demo_pnnp_pipeline,
        demo_train,
        eval_fullres,
        validate_noise_model,
    )

    for tool, argv in ((validate_noise_model, ["--samples", "400"]),
                       (eval_fullres, ["--frames", "1"]), (bench_eval_loop, ["--frames", "1"]),
                       (demo_train, ["--steps", "1"]), (demo_pnnp_pipeline, ["--proxy-steps", "1"])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tool.main(argv)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda:1")
    assert resolve_device("cpu") == torch.device("cpu")


@pytest.mark.parametrize("tool", SLICE11_TOOLS + SLICE12_TOOLS)
def test_new_tools_import_with_jax_blocked(tool):
    """Each tool imports, and builds its argument parser, in a process where
    importing any forbidden package raises."""
    code = (
        "import importlib.abc, sys\n"
        "class Block(importlib.abc.MetaPathFinder):\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in %r:\n"
        "            raise ImportError('blocked: ' + name)\n"
        "for m in [m for m in sys.modules if m.split('.')[0] in %r]:\n"
        "    del sys.modules[m]\n"
        "sys.meta_path.insert(0, Block())\n"
        "import pnnp_tpu_torch.tools.%s as t\n"
        "try:\n"
        "    t.main(['--help'])\n"
        "except SystemExit as e:\n"
        "    assert e.code == 0, e.code\n"
        "print('OK', sorted(m for m in sys.modules if m.split('.')[0] in %r))\n"
        % (FORBIDDEN, FORBIDDEN, tool, FORBIDDEN))
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "OK []" in out.stdout, out.stdout


def test_new_tools_raise_without_cuda(tmp_path, monkeypatch):
    """No CUDA and no ``--cpu``: every new tool that computes refuses the
    host (golden_parity after its preflight, which needs no device)."""
    import pickle

    import torch

    from pnnp_tpu_torch.models import params_to_jax
    from pnnp_tpu_torch.models.proxy import PixelWiseISOProxy
    from pnnp_tpu_torch.tools import (
        ablate_int8_quantset,
        bench_int8,
        check_poisson,
        diagnose_proxy_fit,
        golden_parity,
        int8_roofline,
        oracle_proxy_family,
        oracle_row_deconv,
        profile_prefix_int8,
    )

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    params = tmp_path / "p.pkl"
    with open(params, "wb") as f:
        pickle.dump(params_to_jax(PixelWiseISOProxy(d=8).state_dict()), f)
    for tool, argv in ((check_poisson, ["--n", "10"]), (diagnose_proxy_fit, [str(params), "--d", "8"]),
                       (oracle_row_deconv, ["--steps", "1"]), (oracle_proxy_family, ["--steps", "1"]),
                       (ablate_int8_quantset, ["--small"]), (profile_prefix_int8, ["--small"]),
                       (bench_int8, ["--small"]), (int8_roofline, ["--small"])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tool.main(argv)
    ckpt = tmp_path / "c.pth"
    torch.save({}, ckpt)
    infos = tmp_path / "infos"
    infos.mkdir()
    for name in golden_parity.CONFIGS["SonyA7S2_PNNP"]["infos"]:
        (infos / name).write_bytes(b"")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        golden_parity.main(["--config", "SonyA7S2_PNNP", "--ckpt", str(ckpt),
                            "--infos_dir", str(infos), "--workdir", str(tmp_path / "wd")])
