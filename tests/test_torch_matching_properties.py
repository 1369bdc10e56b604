"""The reference's Alg. 4 property sweeps (``tests/test_matching_
properties.py``) held against the port: for each drawn pair of key chains
the port's ``partitioning_match`` gives the reference's decision, and both
are complete (a stored partitioning matches its own IR) and sound (it
matches another IR iff the key chains are equal; hash never matches
range); the advisor (Eq. 2) weighs consumers by frequency as the
reference's does.  ``max_examples`` are the reference's."""

import pytest

pytest.importorskip("torch")
pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st  # noqa: E402

import repro.core as jcore  # noqa: E402
import repro.core.advisor as jadvisor  # noqa: E402
import repro.core.dsl as jdsl  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
import repro_torch.core.advisor as tadvisor  # noqa: E402
import repro_torch.core.dsl as tdsl  # noqa: E402

ATTRS = ["a", "b", "c", "d"]
PACKAGES = ((jcore, jadvisor, jdsl), (tcore, tadvisor, tdsl))


def _workload_with_chain(core, chain, strategy="hash"):
    wl = core.Workload("w")
    ds = wl.scan("data")
    col = ds
    for name in chain:
        col = col[name]
    wl.partition(col, strategy=strategy)
    wl.write(wl.map(ds, fn=None, tag="noop"), "out")
    return wl


def _matches(core, chain_a, chain_b, strategy_b="hash"):
    wa = _workload_with_chain(core, chain_a)
    wb = _workload_with_chain(core, chain_b, strategy_b)
    ca = core.enumerate_candidates(wa.graph, "data")[0]
    return (ca.signature(),
            core.partitioning_match(ca, "data", wa.graph).matched,
            core.partitioning_match(ca, "data", wb.graph).matched)


@given(st.lists(st.sampled_from(ATTRS), min_size=0, max_size=3),
       st.lists(st.sampled_from(ATTRS), min_size=0, max_size=3))
@settings(max_examples=40, deadline=None)
def test_match_iff_same_chain(chain_a, chain_b):
    got = _matches(tcore, chain_a, chain_b)
    assert got == _matches(jcore, chain_a, chain_b)
    assert got[1]                                  # completeness
    assert got[2] == (chain_a == chain_b)          # soundness


@given(st.lists(st.sampled_from(ATTRS), min_size=1, max_size=3))
@settings(max_examples=20, deadline=None)
def test_hash_never_matches_range(chain):
    got = _matches(tcore, chain, chain, "range")
    assert got == _matches(jcore, chain, chain, "range")
    assert not got[2]


def _heavy_pick(core, advisor, dsl):
    heavy = _workload_with_chain(core, ["a"])
    light = _workload_with_chain(core, ["b"])
    c_heavy = core.enumerate_candidates(heavy.graph, "data")[0]
    c_light = core.enumerate_candidates(light.graph, "data")[0]
    loader = dsl.reddit_loader("loader", "raw", "data", "json")
    hist = core.HistoryStore()
    t = 0.0
    for _ in range(8):                      # heavy consumer: 8 runs
        hist.log_workload(loader, timestamp=t, latency=10.0, input_bytes=1e9)
        hist.log_workload(heavy, timestamp=t + 1, latency=50.0,
                          input_bytes=1e9,
                          candidate_stats={c_heavy.signature(): {
                              "selectivity": 0.1, "distinct_keys": 1e5}})
        t += 10
    hist.log_workload(light, timestamp=t, latency=50.0, input_bytes=1e9,
                      candidate_stats={c_light.signature(): {
                          "selectivity": 0.1, "distinct_keys": 1e5}})
    dec = core.partitioning_creation(loader, "data", hist,
                                     selector=advisor.GreedySelector(),
                                     dataset_bytes=1e9)
    return dec.candidate.signature(), c_heavy.signature()


def test_advisor_weighs_consumers_by_frequency():
    """Eq. 2: with two consumers wanting different keys, both packages'
    advisors pick the key of the more frequent consumer."""
    picks = [_heavy_pick(*pkg) for pkg in PACKAGES]
    assert picks[0] == picks[1]
    assert picks[1][0] == picks[1][1]
