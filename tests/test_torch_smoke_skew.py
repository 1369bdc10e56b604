"""``scripts/torch/skew_smoke.py`` on the CPU against the JAX package's
``scripts/skew_smoke.py``: both exit 0, and the hot-key salt and the
rebucket-only pass report the same padded bytes before and after and the
same skew as the reference's (their result lines are equal)."""

import importlib.util
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
SCRIPTS = {"jax": ROOT / "scripts" / "skew_smoke.py",
           "port": ROOT / "scripts" / "torch" / "skew_smoke.py"}


def _run(pkg, tmp_path):
    extra = ["--device", "cpu"] if pkg == "port" else []
    out = subprocess.run(
        [sys.executable, str(SCRIPTS[pkg]), *extra], capture_output=True,
        text=True, timeout=180, cwd=tmp_path,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin",
             "JAX_PLATFORMS": "cpu", "LACHESIS_BENCH_SMOKE": "1",
             "OMP_NUM_THREADS": "1", "HOME": str(tmp_path),
             "TMPDIR": str(tmp_path)})
    assert out.returncode == 0, (pkg, out.stdout, out.stderr[-4000:])
    return [line for line in out.stdout.splitlines()
            if line.startswith(("skew_smoke: salt:",
                                "skew_smoke: rebucket:"))]


def test_salt_and_rebucket_equal_the_reference(tmp_path):
    got, want = _run("port", tmp_path), _run("jax", tmp_path)
    assert len(want) == 2 and got == want


def test_needs_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    spec = importlib.util.spec_from_file_location("port_skew_smoke",
                                                  SCRIPTS["port"])
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mod.main([])
