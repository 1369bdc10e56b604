"""Nothing the benchmark runs loads JAX, the JAX package or the old
harness, and the references load nothing of the port: top-level module
names compared whole (``repro_torch`` begins with ``repro``)."""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro", "lachesis", "benchmarks"}
PORT = {"repro_torch", "lachesis_torch"}


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def _sources(sub=""):
    return [p for p in (ROOT / "perfbench" / sub).rglob("*.py")
            if "tests" not in p.relative_to(ROOT / "perfbench").parts]


def test_no_source_imports_a_forbidden_module():
    for path in _sources():
        assert not set(_imports(path)) & FORBIDDEN, path


@pytest.mark.parametrize("sub", ["reference", "yardstick"])
def test_references_and_yardsticks_import_nothing_of_the_port(sub):
    for path in _sources(sub):
        assert not set(_imports(path)) & PORT, path


def _run(code: str) -> dict:
    env = dict(os.environ, PYTHONPATH=f"{ROOT / 'src'}:{ROOT}",
               OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


TOP = ("import json, sys\n"
       "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")


def test_reference_loads_nothing_of_the_port_or_jax():
    loaded = set(_run(
        "import perfbench.reference.transformer, perfbench.reference.mamba2,"
        " perfbench.yardstick.cost, perfbench.yardstick.tokens,"
        " perfbench.yardstick.peaks, perfbench.judge\n" + TOP))
    assert not loaded & (FORBIDDEN | PORT)


def test_a_run_loads_no_jax():
    """A whole run of a small cell on the CPU, its readers and its check
    included, then the loaded modules."""
    loaded = set(_run(
        "import time, torch\n"
        "from perfbench import bench\n"
        "from perfbench.tests import tiny\n"
        "c = tiny.cell('internlm2-1.8b.serve-8k')\n"
        "bench.run(c, 1, 0.05, True, torch.device('cpu'), time.perf_counter(),"
        " log=lambda m: None)\n"
        "c = tiny.cell('mamba2-370m.train-2k')\n"
        "bench.run(c, 1, 0.05, True, torch.device('cpu'), time.perf_counter(),"
        " log=lambda m: None)\n"
        "import perfbench.calibrate\n" + TOP))
    assert not loaded & FORBIDDEN
    assert "repro_torch" in loaded
