"""A CPU dry run of ``chip_smoke.py`` phase 11: the cluster tier's three
steps (write, crash, reopen) at a tiny scale factor on CPU tensors, with
the shuffles forced into the card's fused mode.

On the card each hash-partition wrapper counts the kernels it launches;
on the CPU the wrappers run their plain twins and count nothing.  So the
dry run counts the calls into the kernel dispatchers instead — each of
which is one launch on the card — and they must equal the launches that
phase 11 asserts (``P11_LAUNCHES``).  The counts do not depend on the
data's size, only on the path: which writes dispatch on keys, which
partition nodes are elided, and what the rebalance and the Autopilot do.
The steps' own checks (bits after the crash and after a node is lost,
the rebalance bound, the Autopilot's decision, the merged trace) run too.
"""

import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import lachesis_torch  # noqa: E402,F401  (imports the port in its order)
from repro_torch import obs  # noqa: E402
from repro_torch.data import device_repartition as tdr  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402

DISPATCHERS = {"partition_ids": "hash_partition",
               "padded_partition_ids": "hash_partition_padded",
               "scatter_permutation": "scatter_perm"}


@pytest.fixture
def fused_counts(monkeypatch):
    """Shuffles in the card's fused mode on CPU tensors, every call into a
    kernel dispatcher counted under the kernel's name."""
    counts = dict.fromkeys(DISPATCHERS.values(), 0)
    monkeypatch.setattr(tdr, "default_mode", lambda device: "fused")
    for fn, kernel in DISPATCHERS.items():
        def counted(*a, _orig=getattr(tdr, fn), _k=kernel, **kw):
            counts[_k] += 1
            return _orig(*a, **kw)
        monkeypatch.setattr(tdr, fn, counted)
    label = obs.TRACER.process
    yield counts
    obs.disable()
    obs.clear_spans()
    obs.configure(process=label)


def test_phase11_dry_run_predicts_its_launches(tmp_path, fused_counts):
    def reset():
        for k in fused_counts:
            fused_counts[k] = 0

    env = chip_smoke.p11_env(torch, np, "cpu", 0.002, "the CPU (dry run)",
                             reset, lambda: dict(fused_counts))
    outs = {}
    for step in chip_smoke.P11_STEPS:
        obs.clear_spans()
        obs.enable("full", process=step)
        cfg = {"step": step, "root": str(tmp_path / "store"),
               "work": str(tmp_path), "sf": 0.002}
        outs[step] = chip_smoke.P11_STEP_FNS[step](env, cfg)
    assert {s: o["launches"] for s, o in outs.items()} == \
        chip_smoke.P11_LAUNCHES
    reb = outs["reopen"]["rebalance"]
    assert 0 < reb["moved"] < chip_smoke.M
    assert reb["bytes_moved"] <= reb["moved"] / chip_smoke.M \
        * reb["padded_bytes"]
    assert outs["reopen"]["trace"]["incomplete"] >= 1
    assert outs["reopen"]["trace"]["cross_process_flows"] >= 2
    assert outs["reopen"]["repartition"]["cuda_event_s"] is None
