"""The port's examples (``examples/torch/*.py``) on the CPU: each runs to
its end with ``--device cpu`` at its reduced size, each refuses to run
with no card and no ``--device``, and where an example's output is
deterministic it equals the JAX example's — quickstart's advisor pick,
elided shuffles and join results, serve_batch's greedy ids from the
reference's weights carried across with ``convert.params_from_jax``, and
reddit_integration's advisor pick, shuffle counts and join results against
``benchmarks.bench_reddit``'s."""

import importlib.util
import runpy
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.engine import TableVal as JTableVal  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.reduced import reduced  # noqa: E402
from repro_torch.core.executor import TableVal  # noqa: E402
from repro_torch.models import convert  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"
PORT = ROOT / "examples" / "torch"
EXAMPLES = ["quickstart", "autopilot_drift", "serve_batch", "train_lm",
            "elastic_restart", "reddit_integration"]
#: the CPU size of each run: train_lm takes fewer steps than its 120 (it
#: checkpoints every 6, before its failure injected at step 12)
ARGS = {"train_lm": ["--steps", "24"]}


def _load(path: Path, name: str):
    """The example as a module, its ``main`` not run."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_the_port_has_a_counterpart_of_each_example():
    jax_examples = {p.stem for p in (ROOT / "examples").glob("*.py")}
    assert sorted(p.stem for p in PORT.glob("*.py")) == sorted(EXAMPLES)
    assert jax_examples == set(EXAMPLES)


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_runs_to_its_end_on_the_cpu(tmp_path, name):
    # one thread: beside other test workers torch's default thread pool
    # oversubscribes the cores and train_lm slows fifty-fold
    out = subprocess.run(
        [sys.executable, str(PORT / f"{name}.py"), "--device", "cpu",
         *ARGS.get(name, [])], capture_output=True, text=True, timeout=240,
        cwd=tmp_path, env={"PYTHONPATH": str(SRC), "PATH": "/usr/bin:/bin",
                           "TMPDIR": str(tmp_path), "HOME": str(tmp_path),
                           "OMP_NUM_THREADS": "1"})
    assert out.returncode == 0, out.stderr[-4000:]
    assert "on cpu" in out.stdout or name == "autopilot_drift"
    # torch keeps its own caches under TMPDIR; no checkpoint is left
    assert not [p for p in tmp_path.iterdir() if "ckpt" in p.name]


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_needs_a_card_unless_asked_for_the_cpu(name):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    mod = _load(PORT / f"{name}.py", f"port_example_{name}")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mod.main([])


def test_quickstart_matches_the_jax_example():
    """The same advisor pick, the same elided and performed shuffles and
    bytes, a plan-cache hit on the re-run, and the join's every column
    equal to the reference's."""
    want = runpy.run_path(str(ROOT / "examples" / "quickstart.py"),
                          run_name="jax_quickstart")
    got = _load(PORT / "quickstart.py", "port_quickstart").main(
        ["--device", "cpu"])
    assert got["decision"].candidate.signature() == \
        want["decision"].candidate.signature()
    assert got["decision"].candidate.strategy == \
        want["decision"].candidate.strategy
    for k in ("shuffles_performed", "shuffles_elided", "shuffle_bytes"):
        assert getattr(got["result"].stats, k) == \
            getattr(want["result"].stats, k), k
        assert getattr(got["dev_stats"], k) == getattr(want["dev_stats"], k)
    assert got["rerun"].stats.plan_cache_hit and \
        want["rerun"].stats.plan_cache_hit
    assert got["dev_stats"].device_repartitions == \
        want["dev_stats"].device_repartitions == 2
    tables = 0
    for nid, h in want["result"].values.items():
        if not isinstance(h, JTableVal):
            continue
        d = got["result"].values[nid]
        assert isinstance(d, TableVal)
        np.testing.assert_array_equal(d.counts, h.counts)
        assert set(d.columns) == set(h.columns)
        for k in h.columns:
            np.testing.assert_array_equal(np.asarray(d.columns[k]),
                                          np.asarray(h.columns[k]),
                                          err_msg=f"node {nid} col {k}")
        tables += 1
    assert tables > 0


def test_serve_batch_matches_the_jax_example():
    """The JAX example run as it stands, and its weights and prompts
    carried into the port's example: the same config (head dim 16) and the
    same greedy ids."""
    port = _load(PORT / "serve_batch.py", "port_serve_batch")
    jex = _load(ROOT / "examples" / "serve_batch.py", "jax_serve_batch")
    seen = {}
    inner = jex.serve_batch

    def record(cfg, params, prompts, gen_tokens):
        gen, stats = inner(cfg, params, prompts, gen_tokens=gen_tokens)
        seen.update(cfg=cfg, params=params, prompts=prompts, gen=gen)
        return gen, stats

    jex.serve_batch = record
    jex.main()
    cfg = port.config()
    assert cfg == reduced(get_config("internlm2-1.8b"))
    assert (cfg.name, cfg.head_dim, cfg.num_layers, cfg.d_model) == (
        seen["cfg"].name, seen["cfg"].head_dim, seen["cfg"].num_layers,
        seen["cfg"].d_model) and cfg.head_dim == 16
    params = convert.params_from_jax(
        cfg, jax.tree.map(np.asarray, seen["params"]))
    got = port.generate(cfg, params, np.asarray(seen["prompts"]), "cpu",
                        gen_tokens=seen["gen"].shape[1])
    np.testing.assert_array_equal(got, np.asarray(seen["gen"]))


def _tables(values):
    return {nid: v for nid, v in values.items()
            if isinstance(v, (JTableVal, TableVal))}


def test_reddit_integration_matches_the_benchmark(monkeypatch):
    """At a small size, ``benchmarks.bench_reddit.run_case`` (the JAX
    example's scenario, run as it stands with its Session and advisor
    recorded) and the port example's ``run_case`` on the CPU: the same
    advisor pick, the same shuffles performed and elided and bytes
    shuffled over round-robin and partitioned storage, and every table of
    both joins equal."""
    if str(ROOT) not in sys.path:
        monkeypatch.syspath_prepend(str(ROOT))
    from benchmarks import bench_reddit, common
    runs, decisions = [], []

    class Recorded(common.Session):
        def run(self, *a, **kw):
            res = super().run(*a, **kw)
            runs.append(res)
            return res

    def decide(*a, **kw):
        decisions.append(common.advisor_decide(*a, **kw))
        return decisions[-1]

    monkeypatch.setattr(common, "Session", Recorded)
    monkeypatch.setattr(bench_reddit, "advisor_decide", decide)
    bench_reddit.run_case("test", 20_000, 5_000)
    want_base, want_opt = runs[2], runs[5]          # 3 repeats a store
    port = _load(PORT / "reddit_integration.py", "port_reddit")
    np.testing.assert_array_equal(
        port.make_data(20_000, 5_000)[0]["author"],
        bench_reddit.make_data(20_000, 5_000)[0]["author"])
    got = port.run_case("test", 20_000, 5_000, torch.device("cpu"))
    assert got["decision"].candidate.signature() == \
        decisions[0].candidate.signature()
    assert got["decision"].candidate.strategy == \
        decisions[0].candidate.strategy
    for side, want in (("base", want_base), ("opt", want_opt)):
        stats = want.stats
        assert (got[side]["shuffles"], got[side]["elided"],
                got[side]["shuffle_bytes"]) == (
            stats.shuffles_performed, stats.shuffles_elided,
            stats.shuffle_bytes), side
        tables = _tables(want.values)
        assert tables and set(tables) == set(_tables(got[side]["values"]))
        for nid, h in tables.items():
            d = got[side]["values"][nid]
            np.testing.assert_array_equal(d.counts, h.counts)
            assert set(d.columns) == set(h.columns)
            for k in h.columns:
                np.testing.assert_array_equal(
                    np.asarray(d.columns[k]), np.asarray(h.columns[k]),
                    err_msg=f"{side} node {nid} col {k}")
    assert (got["base"]["shuffles"], got["opt"]["shuffles"]) == (2, 0)
