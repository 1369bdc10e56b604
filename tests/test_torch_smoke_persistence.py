"""``scripts/torch/persistence_smoke.py`` on the CPU against the JAX
package's ``scripts/persistence_smoke.py``: each chain (write, then
reopen in a fresh process) exits 0, the port's saved table equals the
reference's bit for bit, and since the on-disk format is shared, a chain
crossed between the packages passes both ways (one package writes and
applies the layout, the other reopens, elides and matches)."""

import importlib.util
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
SCRIPTS = {"jax": ROOT / "scripts" / "persistence_smoke.py",
           "port": ROOT / "scripts" / "torch" / "persistence_smoke.py"}


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


def test_port_chain_saves_the_reference_chains_table(tmp_path):
    for pkg in ("port", "jax"):
        for phase in ("write", "reopen"):
            _run(pkg, phase, tmp_path / pkg, tmp_path)
    got = np.load(tmp_path / "port" / "smoke_expected.npz")
    want = np.load(tmp_path / "jax" / "smoke_expected.npz")
    assert sorted(got.files) == sorted(want.files)
    for k in want.files:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_crossed_chain(tmp_path, writer, reader):
    _run(writer, "write", tmp_path / "store", tmp_path)
    out = _run(reader, "reopen", tmp_path / "store", tmp_path)
    assert "elided its shuffle" in out


def test_needs_a_card_unless_asked_for_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    spec = importlib.util.spec_from_file_location("port_persistence_smoke",
                                                  SCRIPTS["port"])
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mod.main(["write", str(tmp_path / "store")])
    assert not (tmp_path / "store").exists()
