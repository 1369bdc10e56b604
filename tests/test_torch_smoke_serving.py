"""``scripts/torch/serving_stress.py`` on the CPU: a 2 s box of 4 clients
under background d2d flips and a ticking Autopilot exits 0, and the
Chrome trace and metrics it exports are coherent by the script's own
checks (the reference's)."""

import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
SCRIPT = ROOT / "scripts" / "torch" / "serving_stress.py"


def _load():
    spec = importlib.util.spec_from_file_location("port_serving_stress",
                                                  SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_a_short_box_exits_0_with_a_coherent_trace(tmp_path):
    out = subprocess.run(
        [sys.executable, str(SCRIPT), "2", "4", str(tmp_path / "obs"),
         "--device", "cpu"], capture_output=True, text=True, timeout=180,
        cwd=tmp_path,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin",
             "OMP_NUM_THREADS": "1", "HOME": str(tmp_path),
             "TMPDIR": str(tmp_path)})
    assert out.returncode == 0, (out.stdout, out.stderr[-4000:])
    assert "device=cpu clients=4" in out.stdout and "failed=0" in out.stdout
    doc = json.loads((tmp_path / "obs" / "stress_trace.json").read_text())
    assert _load()._check_trace_coherence(doc) == []
    snap = json.loads((tmp_path / "obs" / "stress_metrics.json").read_text())
    assert snap and "serving_latency_seconds_bucket" in (
        tmp_path / "obs" / "stress_metrics.prom").read_text()


def test_needs_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _load().main(["1", "1"])
