"""The attribution of device time to the port's LM spans
(:mod:`perfbench.spans`), over synthetic profiler events shaped as a
CUDA trace gives them (kernels launched on two threads, a backward node
linked to its forward op by ``sequence_nr``, a recomputation on the
backward thread), and over a real CPU trace of the port."""

from types import SimpleNamespace

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from perfbench import spans as S
from perfbench import trace as T
from perfbench.tests import tiny


class Ev:
    """A profiler event with the fields the readers take."""

    def __init__(self, name, start, end, *, device=False, thread=1, id=0,
                 link=0, seq=-1, fwd=0, ann=False, shapes=(), concrete=(),
                 dtypes=(), device_time=0.0):
        self.name = name
        self.time_range = SimpleNamespace(start=start, end=end)
        self.device_type = SimpleNamespace(name="CUDA" if device else "CPU")
        self.thread, self.id, self.linked_correlation_id = thread, id, link
        self.sequence_nr, self.fwd_thread = seq, fwd
        self.is_user_annotation = ann
        self.input_shapes = [list(s) for s in shapes]
        self.concrete_inputs = list(concrete)
        self.input_dtypes = list(dtypes)
        self.device_time_total = device_time


def _span(name, a, b, thread=1, mirrored=True):
    """A recorded span: its host event, and the mirror the profiler puts
    on the device's timeline for a user annotation."""
    out = [Ev(name, a, b, thread=thread, ann=True)]
    if mirrored:
        out.append(Ev(name, a + 1, b, device=True, ann=True))
    return out


def _op(name, a, b, id, k0, k1, kernel="k", thread=1, seq=-1, **kw):
    """A host op, the runtime call in it that launched a device op, and
    the device op: the call and the device op share CUPTI's correlation
    id, counted apart from the ops' ids (which it may equal)."""
    corr = id - 100
    return [Ev(name, a, b, thread=thread, id=id, seq=seq, **kw),
            Ev("cudaLaunchKernel", (a + b) / 2, b, thread=thread, id=corr,
               link=id),
            Ev(kernel, k0, k1, device=True, id=corr, link=id)]


SSD = dict(shapes=[(1, 64, 2, 8), (1, 64, 2), (2,), (1, 64, 1, 16)],
           concrete=["", "", "", "", "", 16], dtypes=["c10::BFloat16"])
SSD_BWD = dict(shapes=[(1, 64, 2, 8), (1, 64, 2), (2,), (1, 64, 1, 16)],
               concrete=["", "", "", "", "", "", "", 16],
               dtypes=["c10::BFloat16"])


def _train_events(with_spans=True):
    """One train step: the forward on thread 1, the backward on autograd's
    thread 2 (a node linked to the loss by sequence number, a layer's
    recomputation under ``lm.mixer``, nodes linked to the mixer and the
    head), the optimizer on thread 1, a copy outside every phase and a
    device op no host op claims.  Times in microseconds."""
    ev = [Ev(T.WINDOW_SPAN, 0, 1000, ann=True)]
    spans = [("lm.train_step", 10, 900, 1), ("lm.forward", 20, 300, 1),
             ("lm.embed", 25, 40, 1), ("lm.mixer", 50, 200, 1),
             ("lm.head", 210, 250, 1), ("lm.loss", 255, 290, 1),
             ("lm.backward", 300, 700, 1), ("lm.mixer", 350, 420, 2),
             ("lm.optimizer", 700, 880, 1)]
    if with_spans:
        for name, a, b, th in spans:
            ev += _span(name, a, b, th)
    ev += _op("aten::embedding", 26, 30, 101, 50, 60)
    ev += _op("aten::mul", 60, 70, 102, 100, 130, seq=7)
    ev += _op("repro_torch::ssd_scan", 80, 120, 103, 130, 200,
              kernel="ssd_fwd", seq=8, device_time=70.0, **SSD)
    ev += _op("aten::mm", 215, 220, 104, 220, 240, seq=9)
    ev += _op("aten::_log_softmax", 256, 260, 105, 260, 280, seq=10)
    for name, a, b, seq in (("LogSoftmaxBackward0", 310, 330, 10),
                            ("MulBackward0", 450, 480, 7),
                            ("SsdScanBackward", 500, 560, 8),
                            ("MmBackward0", 600, 620, 9)):
        ev.append(Ev(S.BACKWARD_NODE + name, a, b, thread=2, seq=seq, fwd=1))
    ev += _op("aten::_log_softmax_backward_data", 312, 318, 201, 330, 340,
              thread=2)
    ev += _op("aten::mul", 355, 360, 202, 420, 440, thread=2, seq=3)
    ev += _op("aten::mul", 452, 456, 203, 480, 500, thread=2)
    ev += _op("repro_torch::ssd_scan_backward", 505, 550, 204, 560, 620,
              kernel="ssd_bwd", thread=2, device_time=60.0, **SSD_BWD)
    ev += _op("aten::mm", 602, 610, 205, 620, 640, thread=2)
    ev += _op("aten::_foreach_mul_", 710, 720, 106, 720, 760)
    ev += _op("aten::copy_", 950, 955, 107, 955, 960, kernel="Memcpy DtoH")
    ev.append(Ev("stray", 965, 970, device=True, id=900, link=999))
    return sorted(ev, key=lambda e: (e.time_range.start, -e.time_range.end))


def test_device_ops_go_to_their_phase_and_component():
    sp = S.attribute(_train_events())
    us = 1e-6
    assert sp.device_s == pytest.approx(330 * us)
    assert sp.phase_s == pytest.approx({
        "lm.forward": 150 * us, "lm.backward": 130 * us,
        "lm.optimizer": 40 * us, S.NONE: 5 * us, S.UNLINKED: 5 * us})
    assert sp.component_s == pytest.approx({
        ("lm.forward", "lm.embed"): 10 * us,
        ("lm.forward", "lm.mixer"): 100 * us,
        ("lm.forward", "lm.head"): 20 * us,
        ("lm.forward", "lm.loss"): 20 * us,
        ("lm.backward", "lm.loss"): 10 * us,       # by sequence_nr
        ("lm.backward", "lm.mixer"): 100 * us,     # recompute + two nodes
        ("lm.backward", "lm.head"): 20 * us,
        ("lm.optimizer", S.NONE): 40 * us,
        (S.NONE, S.NONE): 5 * us, (S.UNLINKED, S.NONE): 5 * us})
    assert sp.launches == {"lm.forward": 5, "lm.backward": 5,
                           "lm.optimizer": 1, S.NONE: 1, S.UNLINKED: 1}
    assert sp.counts["lm.train_step"] == 1 and sp.counts["lm.mixer"] == 2
    assert S.mixer_ms_per_step(sp) == pytest.approx(0.2)
    assert S.optimizer_ms_per_step(sp) == pytest.approx(0.04)
    assert S.decode_attn_ms_per_token(sp) is None
    assert S.decode_idle_share(sp) is None
    assert sum(sp.phase_s.values()) == pytest.approx(sp.device_s)
    assert sum(sp.component_s.values()) == pytest.approx(sp.device_s)


def test_the_spans_move_no_existing_reading():
    """The existing reduction reads the same with the spans (and their
    mirrors on the device's timeline) as without them."""
    a = T.reduce_events(_train_events(with_spans=True))
    b = T.reduce_events(_train_events(with_spans=False))
    assert T.idle_share(a) == T.idle_share(b)
    assert a.window_s == b.window_s and a.busy_s == b.busy_s
    assert a.device_ops == b.device_ops
    assert a.calls == b.calls and set(a.calls) == {
        "repro_torch::ssd_scan", "repro_torch::ssd_scan_backward"}
    for ops in (("repro_torch::ssd_scan",),
                ("repro_torch::ssd_scan_backward",)):
        assert T.roofline(a, ops) == T.roofline(b, ops) is not None
    assert S.attribute(_train_events(with_spans=False)) is None


def _serve_events():
    """One call: a prefill, two decode steps (the mixer's op and ``pick``'s
    argmax each), the read-back copy inside ``lm.decode``."""
    ev = [Ev(T.WINDOW_SPAN, 0, 1000, ann=True)]
    for name, a, b in (("lm.serve_batch", 5, 990), ("lm.prefill", 10, 200),
                       ("lm.decode", 200, 900), ("lm.decode_step", 210, 400),
                       ("lm.decode_step", 410, 600)):
        ev += _span(name, a, b)
    ev += _span("lm.mixer", 20, 100)
    ev += _op("repro_torch::flash_attention", 30, 60, 301, 60, 180)
    i = 400
    for a in (210, 410):
        ev += _span("lm.mixer", a + 5, a + 100)
        ev += _op("aten::einsum", a + 10, a + 20, i, a + 20, a + 70)
        ev += _op("aten::argmax", a + 110, a + 120, i + 1, a + 120, a + 130)
        i += 2
    ev += _op("aten::copy_", 870, 875, 500, 875, 880)
    return sorted(ev, key=lambda e: (e.time_range.start, -e.time_range.end))


def test_decode_readings():
    sp = S.attribute(_serve_events())
    assert sp.counts["lm.decode_step"] == 2
    assert S.decode_attn_ms_per_token(sp) == pytest.approx(0.05)
    assert S.decode_launches_per_token(sp) == pytest.approx(2.0)
    # the decode span's 700 us, of which two steps' 60 us and the read-back
    # 5 us are busy
    assert S.decode_idle_share(sp) == pytest.approx(100 * (1 - 125 / 700))
    assert sp.phase_s["lm.prefill"] == pytest.approx(120e-6)
    assert sp.phase_s["lm.decode"] == pytest.approx(5e-6)
    assert S.mixer_ms_per_step(sp) is None


def test_innermost_takes_the_latest_open_interval():
    ivs = {1: [(0, 10, "a"), (2, 5, "b"), (3, 4, "c"), (6, 9, "d")]}
    qs = [(1, t) for t in (1, 3.5, 4.5, 5.5, 7, 11)] + [(2, 3)]
    assert S._innermost(ivs, qs) == ["a", "c", "b", "a", "d", None, None]


def test_launch_calls():
    for name in ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                 "cudaMemcpyAsync", "cudaMemsetAsync", "cuLaunchKernelEx"):
        assert S._is_launch(Ev(name, 0, 1))
    for name in ("aten::cumsum", "lm.mixer", "custom::cuda_op", "cube"):
        assert not S._is_launch(Ev(name, 0, 1))


def test_a_real_cpu_trace_of_the_port():
    """A tiny train cell's traced steps with the port's tracer on: every
    span is on the profiler's timeline, and with no device ops every
    reading is None."""
    from repro_torch import obs
    cell = tiny.cell("mamba2-370m.train-2k")
    drv = cell.driver
    state = drv.setup(cell, 7, torch.device("cpu"))
    obs.enable("full")
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with record_function(T.WINDOW_SPAN):
                drv.traced(state)
    finally:
        obs.disable()
        obs.clear_spans()
    sp = S.attribute(prof.events())
    steps = cell.traffic["trace_steps"]
    assert sp.counts["lm.train_step"] == steps
    assert sp.counts["lm.optimizer"] == steps
    layers = cell.program_cfg.num_layers
    assert sp.counts["lm.mixer"] == 2 * layers * steps    # with recompute
    assert sp.device_s == 0 and S.mixer_ms_per_step(sp) is None
