"""A CPU dry run of ``chip_smoke.py`` phase 18 (a): every reduced config
served at the CLI's shape and reduced internlm2-1.8b trained, with the
kernels' Functions on CPU stand-ins (each forward kernel replaced by its
plain twin, counted as a launch) and the flash dispatcher's CUDA route
(``kernel_attention``) taken by CPU tensors.  The launches counted and the
head dim the launcher sees must be those phase 18 asserts; and (b)'s
chains run the CI job's commands."""

import re
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config, list_archs  # noqa: E402
from repro_torch.configs.reduced import reduced  # noqa: E402
from repro_torch.kernels._build import count_launch  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention as fa  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import attention_ref  # noqa: E402
from repro_torch.kernels.ssd_scan import ops as ss_ops  # noqa: E402
from repro_torch.kernels.ssd_scan import ssd_scan as ss  # noqa: E402
from repro_torch.kernels.ssd_scan.ref import ssd_ref  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture
def chip_smoke(monkeypatch):
    """``chip_smoke`` with the CUDA routes' Functions on CPU tensors."""
    def flash(q, k, v, **kw):
        count_launch(fa.LAUNCHES, "flash_attention")
        return attention_ref(q, k, v, **kw)

    def scan(x, dt, A, Bm, Cm, chunk):
        count_launch(ss.LAUNCHES, "ssd_scan")
        return ssd_ref(x, dt, A, Bm, Cm, chunk)

    monkeypatch.setattr(fa, "flash_attention", flash)
    monkeypatch.setattr(ss, "ssd_scan", scan)
    monkeypatch.setattr(fa_ops, "attention", lambda q, k, v, *, causal=True,
                        window=None, softcap=0.0, scale=None:
                        fa_ops.kernel_attention(q, k, v, causal, window,
                                                softcap, scale))
    monkeypatch.setattr(ss_ops, "ssd", lambda x, dt, A, Bm, Cm, *, chunk=256:
                        ss_ops.KernelSSD.apply(x, dt, A, Bm, Cm, chunk))
    if str(ROOT) not in sys.path:
        monkeypatch.syspath_prepend(str(ROOT))
    import chip_smoke as C
    fa.reset_launches()
    ss.reset_launches()
    yield C
    fa.reset_launches()
    ss.reset_launches()


def test_phase18_serve_dry_run(chip_smoke):
    """Every reduced config at the CLI's shape: the CLI and serve_batch
    run, the ids of the two routes compared, each prefill's launches
    ``p18_expected``'s, all at head dim 32 (the reduced configs' 16
    padded), and every config reached."""
    C = chip_smoke
    env = C.p12_env(torch, np, "cpu", "the CPU (dry run)")
    out = C.p18_serve(env, fa, ss, "cpu")
    assert sorted(out) == sorted(list_archs())
    for arch, counts in out.items():
        cfg = reduced(get_config(arch))
        assert cfg.head_dim == 16
        assert counts == C.p18_expected(cfg), arch
    assert out["whisper-small"]["flash_attention"] == 2 + 2 + 2
    assert out["mamba2-370m"] == {"flash_attention": 0, "ssd_scan": 2}
    assert out["deepseek-v2-236b"]["flash_attention"] == 3


def test_phase18_train_dry_run(chip_smoke):
    """Reduced internlm2-1.8b's train steps at the CLI's batch: the launches
    and recomputes per step phase 18 asserts, at head dim 32, the loss
    and leaves held against the CPU route (here the same arithmetic, but
    for the order of threaded sums)."""
    C = chip_smoke
    env = C.p12_env(torch, np, "cpu", "the CPU (dry run)")
    out = C.p18_train(env, fa, "cpu")
    n_steps = C.P18_TRAIN[2]
    assert out["launches"] == n_steps * C.P18_TRAIN_LAUNCHES["launches"]
    assert out["grad_rel"] <= C.P17_GRAD_TOL
    assert len(out["losses"]) == n_steps


def test_phase18_chains_run_the_ci_jobs_commands():
    """(b)'s chains are the CI job's runs of the reference's scripts, in
    its order, the store directory a temporary one, each script ported."""
    ci = (ROOT / ".github" / "workflows" / "ci.yml").read_text()
    want = {}
    for name, args in re.findall(r"python scripts/(\w+)\.py ?([^\n]*)", ci):
        if (ROOT / "scripts" / "torch" / f"{name}.py").exists():
            want.setdefault(name, []).append(tuple(
                "{dir}" if a.startswith(".ci-") else a for a in args.split()))
    import importlib.util
    spec = importlib.util.spec_from_file_location("chip_smoke_chains",
                                                  ROOT / "chip_smoke.py")
    C = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(C)
    assert {name: list(steps) for name, steps in C.P18_CHAINS} == want
