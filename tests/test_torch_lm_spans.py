"""The LM path's spans (``lm.*``) on the CPU, at reduced float32 configs
of internlm2-1.8b (attention and a dense FFN) and mamba2-370m (SSD, no
FFN): with the tracer on, a train step and a ``serve_batch`` call open
exactly the documented spans, nested as documented, and each lands on a
running profiler's host timeline; with the tracer off none is recorded
or reaches the profiler, and the results are bit-identical."""

from collections import Counter

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch import obs, tree  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.reduced import reduced  # noqa: E402
from repro_torch.launch import steps as TS  # noqa: E402
from repro_torch.launch.serve import serve_batch  # noqa: E402

ARCHS = ["internlm2-1.8b", "mamba2-370m"]
PHASES = {"lm.train_step", "lm.forward", "lm.backward", "lm.optimizer"}
GEN = 5


@pytest.fixture(autouse=True)
def tracer_off():
    obs.disable()
    obs.clear_spans()
    yield
    obs.disable()
    obs.clear_spans()


@pytest.fixture(scope="module", params=ARCHS)
def cfg(request):
    return reduced(get_config(request.param))


def _state(cfg):
    opt = TS.make_optimizer(cfg)
    gen = torch.Generator().manual_seed(0)
    return opt, TS.init_train_state(cfg, gen, opt)


def _batch(cfg, B=2, S=16):
    tok = np.random.default_rng(1).integers(0, cfg.vocab_size, (B, S),
                                            dtype=np.int32)
    return {"tokens": torch.as_tensor(tok),
            "labels": torch.as_tensor(np.roll(tok, -1, axis=1))}


def _prompts(cfg, B=2, S=12):
    return np.random.default_rng(2).integers(0, cfg.vocab_size, (B, S),
                                             dtype=np.int32)


def _train(cfg, profiler=False):
    opt, state = _state(cfg)
    step = TS.make_train_step(cfg, opt)
    if not profiler:
        return step(state, _batch(cfg))[0], None
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        new = step(state, _batch(cfg))[0]
    return new, prof


def _lm_events(prof):
    return Counter(e.name for e in prof.events() if e.name.startswith("lm."))


def _ancestors(sp, by_id):
    out = []
    while sp.parent_id is not None:
        sp = by_id[sp.parent_id]
        out.append(sp.name)
    return out


def test_a_train_step_opens_the_documented_spans(cfg):
    obs.enable("full")
    _, prof = _train(cfg, profiler=True)
    spans = obs.finished_spans()
    by_id = {s.span_id: s for s in spans}
    names = Counter(s.name for s in spans)
    ffn_layers = sum(s.ffn != "none" for s in cfg.all_specs)
    want = PHASES | {"lm.embed", "lm.mixer", "lm.head", "lm.loss"}
    assert set(names) == want | ({"lm.ffn"} if ffn_layers else set())
    assert all(s.cat == "lm" for s in spans)
    for phase in PHASES:
        assert names[phase] == 1
    fwd = [s for s in spans if "lm.forward" in _ancestors(s, by_id)]
    for s in fwd:
        assert _ancestors(s, by_id)[-2:] == ["lm.forward", "lm.train_step"]
    fwd_names = Counter(s.name for s in fwd)
    assert fwd_names["lm.mixer"] == cfg.num_layers
    assert fwd_names["lm.ffn"] == ffn_layers
    assert fwd_names["lm.embed"] == fwd_names["lm.head"] == 1
    assert fwd_names["lm.loss"] == 1
    assert [s.args["kind"] for s in fwd if s.name == "lm.mixer"] == \
        [spec.mixer for spec in cfg.all_specs]
    # remat recomputes each layer in the backward, under its spans again
    bwd = Counter(s.name for s in spans
                  if "lm.backward" in _ancestors(s, by_id))
    assert bwd["lm.mixer"] == (cfg.num_layers if cfg.remat else 0)
    for s in spans:
        if s.name in ("lm.forward", "lm.backward", "lm.optimizer"):
            assert _ancestors(s, by_id) == ["lm.train_step"]
    # each recorded span is on the profiler's host timeline
    assert _lm_events(prof) == names


def test_serve_batch_opens_the_documented_spans(cfg):
    obs.enable("full")
    opt, state = _state(cfg)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _, stats = serve_batch(cfg, state["params"], _prompts(cfg), GEN,
                               device="cpu")
    spans = obs.finished_spans()
    by_id = {s.span_id: s for s in spans}
    by_name = {s.name: s for s in spans}
    names = Counter(s.name for s in spans)
    ffn = {"lm.ffn"} if any(s.ffn != "none" for s in cfg.all_specs) else set()
    assert set(names) == {"lm.serve_batch", "lm.prefill", "lm.decode",
                          "lm.decode_step", "lm.embed", "lm.mixer",
                          "lm.head"} | ffn
    root = by_name["lm.serve_batch"]
    assert root.parent_id is None
    assert root.args == {"batch": 2, "prompt_len": 12, "gen_tokens": GEN}
    for name in ("lm.prefill", "lm.decode"):
        assert names[name] == 1
        assert _ancestors(by_name[name], by_id) == ["lm.serve_batch"]
    steps = [s for s in spans if s.name == "lm.decode_step"]
    assert len(steps) == GEN
    for s in steps:
        assert _ancestors(s, by_id) == ["lm.decode", "lm.serve_batch"]
    # a forward a step and one for the prefill
    assert names["lm.mixer"] == cfg.num_layers * (GEN + 1)
    assert by_name["lm.prefill"].dur_s == pytest.approx(stats["prefill_s"],
                                                        abs=1e-3)
    assert by_name["lm.decode"].dur_s == pytest.approx(stats["decode_s"],
                                                       abs=1e-3)
    assert _lm_events(prof) == names


def test_tracing_off_records_nothing_and_changes_no_bit(cfg):
    new_off, prof = _train(cfg, profiler=True)
    assert obs.finished_spans() == [] and _lm_events(prof) == Counter()
    opt, state = _state(cfg)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        toks_off, _ = serve_batch(cfg, state["params"], _prompts(cfg), GEN,
                                  device="cpu")
    assert obs.finished_spans() == [] and _lm_events(prof) == Counter()

    obs.enable("full")
    new_on, _ = _train(cfg)
    toks_on, _ = serve_batch(cfg, state["params"], _prompts(cfg), GEN,
                             device="cpu")
    assert obs.finished_spans()
    np.testing.assert_array_equal(toks_on, toks_off)
    on, off = tree.leaves(new_on), tree.leaves(new_off)
    assert len(on) == len(off)
    for x, y in zip(on, off):
        assert torch.equal(x, y)


def test_an_unsampled_root_mirrors_nothing(cfg):
    """In sampled mode a root that sampling passes over records no span
    and puts nothing on the profiler's timeline."""
    obs.enable("sampled", sample_every=1_000_000)
    with obs.span("warm-up root"):      # past the sampling clock's tick
        pass
    obs.clear_spans()
    _, prof = _train(cfg, profiler=True)
    assert obs.finished_spans() == [] and _lm_events(prof) == Counter()
