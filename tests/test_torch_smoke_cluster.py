"""``scripts/torch/cluster_smoke.py`` on the CPU against the JAX
package's ``scripts/cluster_smoke.py``: each three-process chain (write;
a crash mid-rebalance; reopen, recover, rebalance, lose a node, stitch the
trace) exits 0, and every dataset the port's chain serves after its
reopen is bit-equal to the reference chain's expected bits."""

import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.api import Session  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
SCRIPTS = {"jax": ROOT / "scripts" / "cluster_smoke.py",
           "port": ROOT / "scripts" / "torch" / "cluster_smoke.py"}


def _run(pkg, phase, store, tmp_path):
    extra = ["--device", "cpu"] if pkg == "port" else []
    out = subprocess.run(
        [sys.executable, str(SCRIPTS[pkg]), phase, str(store), *extra],
        capture_output=True, text=True, timeout=180, cwd=tmp_path,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin",
             "JAX_PLATFORMS": "cpu", "OMP_NUM_THREADS": "1",
             "HOME": str(tmp_path), "TMPDIR": str(tmp_path)})
    assert out.returncode == 0, (pkg, phase, out.stdout, out.stderr[-4000:])
    return out.stdout


def test_port_chain_serves_the_reference_chains_bits(tmp_path):
    for pkg in ("port", "jax"):
        for phase in ("write", "crash", "reopen"):
            _run(pkg, phase, tmp_path / pkg, tmp_path)
    doc = json.loads((tmp_path / "port" / "telemetry" /
                      "cluster_trace.json").read_text())
    assert set(doc["otherData"]["processes"]) == {"write", "crash", "reopen"}
    want = np.load(tmp_path / "jax" / "smoke_expected.npz")
    sess = Session(store_path=str(tmp_path / "port"), device="cpu")
    assert sess.store.placement_epoch == 1
    for key in want.files:
        name, col = key.split("/", 1)
        got = np.asarray(sess.store.read(name).gather()[col])
        assert got.dtype == want[key].dtype, key
        np.testing.assert_array_equal(got, want[key], err_msg=key)


def test_needs_a_card_unless_asked_for_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    spec = importlib.util.spec_from_file_location("port_cluster_smoke",
                                                  SCRIPTS["port"])
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mod.main(["write", str(tmp_path / "store")])
