"""The harness on the CPU at tiny sizes: every cell runs and is judged
correct; a new configuration, traffic mix, driver, limits and metric file
are found by name with no file edited; what a run imports; a run without a
card or without the port fails."""

import ast
import hashlib
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from portbench.tests import tiny

REPO = tiny.REPO


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return tiny.tiny_tree(tmp_path_factory.mktemp("tiny"))


@pytest.mark.parametrize("name", tiny.CELLS)
def test_cell_runs_and_is_correct(tree, name):
    line, checks = tiny.run(*tree, name)
    assert line["correct"], line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    assert list(line)[-1] == "checks"
    assert "setup_s" in line["metrics"] and len(line["metrics"]) >= 2
    assert line["device"]["platform"] == "cpu"  # a CPU run names no device metric


def _digest(root: Path) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def test_new_files_are_found_by_name(tmp_path):
    bench_file, root = tiny.tiny_tree(tmp_path)
    before = _digest(root)
    bench = json.loads(bench_file.read_text())
    # a configuration: the IMX686 one at another size
    cfg = json.loads((tmp_path / "portbench/configs/imx686_pnnp_unet32.json").read_text())
    cfg["dst_eval"].update(H=96, W=128)
    (root / "configs" / "imx686_wide.json").write_text(json.dumps(cfg))
    bench["configs"].append(dict(bench["configs"][1], name="imx686_wide",
                                 file="portbench/configs/imx686_wide.json"))
    # a traffic mix over a new driver, limits of the new cell, a new metric
    (root / "traffic" / "two_frames.json").write_text(json.dumps(
        {"driver": "resident_twice", "frames": 2, "sample_frames": 1, "profile_units": 2}))
    (root / "drivers" / "resident_twice.py").write_text(
        "from portbench.drivers.eval_resident import Driver as Base\n\n\n"
        "class Driver(Base):\n"
        "    def step(self, spans):\n"
        "        super().step(spans)\n"
        "        super().step(spans)\n")
    (root / "limits" / "imx686_wide.two.json").write_text(
        json.dumps(tiny.TINY_LIMITS["imx686_eval_resident"]))
    (root / "metrics" / "frames_seen.py").write_text(
        "def read(rec):\n    return float(len(rec.unit_s))\n")
    bench["workloads"].append({"name": "imx686_wide.two", "config": "imx686_wide",
                               "traffic": "two_frames", "chips": 1, "why": "a test cell"})
    bench["end_to_end"].append({"name": "frames_seen", "unit": "frames", "better": "higher",
                                "bound": 0.25, "source": "host_clock",
                                "workloads": ["imx686_wide.two"]})
    bench_file.write_text(json.dumps(bench))
    line, _ = tiny.run(bench_file, root, "imx686_wide.two")
    assert line["correct"], line["checks"]
    assert line["metrics"]["frames_seen"]["value"] == line["attempted"] > 0
    after = _digest(root)
    assert {k: v for k, v in after.items() if k in before} == before  # nothing edited


def _modules_after(code: str, cwd=REPO) -> set:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys\n"
                          "print(sorted({m.split('.')[0] for m in sys.modules}))"],
                         cwd=cwd, capture_output=True, text=True, timeout=600,
                         env=dict(os.environ, PYTHONPATH=str(REPO)))
    assert out.returncode == 0, out.stderr[-3000:]
    return set(eval(out.stdout.strip().splitlines()[-1]))


def test_a_run_imports_neither_jax_nor_the_jax_package(tmp_path):
    code = ("import pathlib\nfrom portbench import run, harness\nfrom portbench.tests import tiny\n"
            "tree = tiny.tiny_tree(pathlib.Path(%r))\n"
            "for name in tiny.CELLS:\n    tiny.run(*tree, name)\n"
            "root = harness.ROOT\n"
            "for p in (root / 'drivers').glob('*.py'):\n    harness.load_module(p, p.stem)\n"
            "for p in (root / 'metrics').glob('*.py'):\n    harness.load_module(p, p.stem)\n"
            % str(tmp_path))
    names = _modules_after(code)
    assert "pnnp_tpu_torch" in names  # the program ran
    assert not names & {"jax", "jaxlib", "flax", "pnnp_tpu"}


def test_the_reference_imports_nothing_of_either_package():
    code = ("import importlib, pkgutil, portbench.reference as r\n"
            "for m in pkgutil.iter_modules(r.__path__):\n"
            "    importlib.import_module('portbench.reference.' + m.name)\n")
    names = _modules_after(code)
    assert not names & {"jax", "jaxlib", "flax", "pnnp_tpu", "pnnp_tpu_torch"}
    for p in (REPO / "portbench" / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(p.read_text())):
            if isinstance(node, ast.Import):
                tops = {a.name.split(".")[0] for a in node.names}
            elif isinstance(node, ast.ImportFrom):
                tops = {(node.module or "").split(".")[0]}
            else:
                continue
            assert not tops & {"jax", "jaxlib", "flax", "pnnp_tpu", "pnnp_tpu_torch"}, p


def test_no_card_no_result():
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload",
                          "sony_eval_sweep", "--seed", str(2**31 + 5), "--seconds", "1",
                          "--trace", "0"], cwd=REPO, capture_output=True, text=True,
                         timeout=600, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_without_the_port_a_run_fails(tmp_path):
    """A checkout that holds only BENCHMARK.json and portbench/."""
    import shutil

    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(REPO / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import sys, time\nsys.path.insert(0, '.')\nfrom portbench import harness\n"
            "cell = harness.Cell(harness.ROOT.parent / 'BENCHMARK.json', 'imx686_eval_resident')\n"
            "harness.run(cell, 1, 0.1, False, 'cpu', time.perf_counter())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                         text=True, timeout=600, env={"PATH": os.environ["PATH"]})
    assert out.returncode != 0
    assert "pnnp_tpu_torch" in out.stderr
