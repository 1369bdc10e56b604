"""Runs on the CPU with the look for a card skipped: the result line, a
run that finds no card, a checkout without the port, and the comparison
that decides ``correct`` seeing the planted faults and the control."""

import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from perfbench import bench, judge
from perfbench.tests import tiny

ROOT = Path(__file__).resolve().parents[2]
CPU = torch.device("cpu")
TRAIN = ["mamba2-370m.train-2k", "internlm2-1.8b.train-16k"]
SERVE = "internlm2-1.8b.serve-8k"
SATURATED = "internlm2-1.8b.serve-8k-saturated"


def _run(cell, trace=False, seed=2**31 + 11):
    return bench.run(cell, seed, 0.05, trace, CPU, time.perf_counter(),
                     log=lambda m: None)


@pytest.mark.parametrize("workload", TRAIN + [SERVE, SATURATED])
@pytest.mark.parametrize("trace", [False, True])
def test_result_line(workload, trace):
    cell = tiny.cell(workload)
    out = _run(cell, trace)
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    assert list(out) == keys + (["breakdown"] if trace else []) + ["checks"]
    assert out["correct"] is True and out["failed"] == 0
    assert out["attempted"] > 0
    names = {m["name"] for m in (cell.per_layer if trace else cell.e2e)}
    assert set(out["metrics"]) <= names
    if not trace:
        assert set(out["metrics"]) == names
    for m in out["metrics"].values():
        assert set(m) == {"value", "unit"} and np.isfinite(m["value"])
    dev = out["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)
    assert ("busy_s" in dev) == trace
    assert set(out["checks"]) == set(cell.limits)
    json.dumps(out)
    if trace:
        assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}


def _script(*args, cwd=ROOT):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, "perfbench/run.py", *args],
                          cwd=cwd, env=env, capture_output=True, text=True,
                          timeout=300)


ARGS = ["--workload", SERVE, "--seed", "2147483999", "--seconds", "1",
        "--trace", "0"]


def test_no_card_no_result():
    """With no CUDA card the run prints no result and fails: it never
    falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = _script(*ARGS)
    assert out.returncode == 3 and out.stdout.strip() == ""


def test_a_checkout_without_the_port_fails(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _script(*ARGS, cwd=tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""


# ---------------------------------------------------------------------------
# Faults planted under the timed path, and the control
# ---------------------------------------------------------------------------

def _small(workload, control=False):
    """A cell small enough for the CPU whose numbers fall on the same
    sides of the cell's limits as the card's size does: serving at the
    published widths (two layers), since a served logit's gap scales with
    the logits, and for the control with 128 served tokens compared, since
    the widest gap grows with the tokens compared; for the control Mamba-2
    at six layers, since the float8 control's gradient gaps grow with
    depth."""
    if workload == SERVE:
        traffic = (dict(batch=4, prompt_len=32, gen_tokens=16,
                        check_requests=8) if control else
                   dict(prompt_len=16, check_requests=2))
        return tiny.cell(workload, "bfloat16", tiny.WIDE, **traffic)
    if workload == TRAIN[0] and control:
        return tiny.cell(workload, "bfloat16", {"num_layers": 6})
    return tiny.cell(workload, "bfloat16")


def _state_unchanged(monkeypatch):
    from repro_torch.launch import steps

    def make(cfg, opt, **kw):
        def step(state, batch):
            loss, met, _ = steps.value_and_grad(cfg, state["params"], batch)
            return state, dict(met, loss=loss)
        return step
    monkeypatch.setattr(steps, "make_train_step", make)


def _half_batch(monkeypatch):
    from repro_torch.launch import steps
    real = steps.make_train_step

    def make(cfg, opt, **kw):
        inner = real(cfg, opt, **kw)

        def step(state, batch):
            return inner(state, {k: v[:max(1, v.shape[0] // 2)]
                                 for k, v in batch.items()})
        return step
    monkeypatch.setattr(steps, "make_train_step", make)


def _token_altered(monkeypatch):
    from repro_torch.launch import serve
    real = serve.serve_batch

    def serve_batch(cfg, params, prompts, gen, **kw):
        out, stats = real(cfg, params, prompts, gen, **kw)
        out = out.copy()
        out[:, 0] = (out[:, 0] + 1) % cfg.vocab_size
        return out, stats
    monkeypatch.setattr(serve, "serve_batch", serve_batch)


def _cache_unchanged(monkeypatch):
    """Decode steps that leave the KV cache as it was."""
    from repro_torch.models import layers
    real = layers.cache_write

    def cache_write(buf, start, val):
        if val.shape[1] > 1:
            real(buf, start, val)
    monkeypatch.setattr(layers, "cache_write", cache_write)


@pytest.mark.parametrize("workload, fault", [
    (TRAIN[0], _state_unchanged), (TRAIN[0], _half_batch),
    (TRAIN[1], _state_unchanged), (TRAIN[1], _half_batch),
    (SERVE, _token_altered), (SERVE, _cache_unchanged)])
def test_a_fault_comes_out_not_correct(workload, fault, monkeypatch):
    """The same cells run correct unplanted (``test_result_line``, and
    the program's side of ``test_the_control_comes_out_not_correct``)."""
    fault(monkeypatch)
    assert _run(_small(workload))["correct"] is False


@pytest.mark.parametrize("workload", TRAIN + [SERVE])
def test_the_control_comes_out_not_correct(workload):
    """The reference with float8 GEMMs in the port's place fails the
    cell's limits, where the port in bfloat16 passes them."""
    cell = _small(workload, control=True)
    got = cell.driver.calibrate(cell, 2**31 + 21, CPU, True)
    assert judge.passed(judge.checks(got["program"], cell.limits))
    assert not judge.passed(judge.checks(got["control"], cell.limits))
