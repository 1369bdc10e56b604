"""The torch port's training path against the JAX package on the CPU, at
reduced float32 configs of internlm2-1.8b (attention) and mamba2-370m
(SSD): the loss and every gradient leaf from carried weights, AdamW train
steps with and without accumulation, compressed steps, checkpoints
crossing between the packages both ways, the token pipeline, restarts,
the CLI, and the autograd Functions that give the kernels a gradient
(their backward run here with a CPU stand-in for the forward kernel)."""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.checkpoint import checkpoint as JCk  # noqa: E402
from repro.configs import get_config  # noqa: E402
from repro.configs.reduced import reduced  # noqa: E402
from repro.data import pipeline as JP  # noqa: E402
from repro.launch import steps as JS  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch import tree  # noqa: E402
from repro_torch.checkpoint import checkpoint as TCk  # noqa: E402
from repro_torch.data import pipeline as TP  # noqa: E402
from repro_torch.kernels._build import count_launch  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention as fa  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import attention_ref  # noqa: E402
from repro_torch.kernels.ssd_scan import ops as ss_ops  # noqa: E402
from repro_torch.kernels.ssd_scan import ssd_scan as ss  # noqa: E402
from repro_torch.kernels.ssd_scan.ref import ssd_ref  # noqa: E402
from repro_torch.launch import steps as TS  # noqa: E402
from repro_torch.launch import train as TTrain  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"
ARCHS = ["internlm2-1.8b", "mamba2-370m"]
#: float32 gradients: the two packages' attention and SSD oracles, GEMMs
#: and reductions sum in other orders
GRAD_ABS, GRAD_REL_RMS = 1e-5, 1e-4


def _np(t):
    return jax.tree.map(np.asarray, t)


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    cfg = reduced(get_config(request.param))
    params = JT.init_params(cfg, jax.random.PRNGKey(0))
    return cfg, params


def _batch(cfg, B=4, S=32, seed=0):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (B, S), dtype=np.int32)
    return {"tokens": tokens, "labels": np.roll(tokens, -1, axis=1)}


def _port_state(cfg, jstate):
    return convert.state_from_jax(cfg, _np(jstate))


def _rel_rms(got, want):
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                 1e-30))


def _compare_trees(cfg, want_jax, got_port, abs_tol, rel_tol, what):
    """``want_jax`` a reference params-shaped tree, ``got_port`` the
    port's: every leaf, unstacked to the port's layout."""
    want = convert.state_from_jax(cfg, {"params": _np(want_jax)})["params"]
    pw, pg = tree.flatten_with_paths(want), tree.flatten_with_paths(got_port)
    assert [p for p, _ in pw] == [p for p, _ in pg]
    worst = 0.0
    for (path, w), (_, g) in zip(pw, pg):
        w, g = w.float().numpy(), g.detach().float().numpy()
        assert g.shape == w.shape, path
        np.testing.assert_allclose(g, w, rtol=0, atol=abs_tol + rel_tol *
                                   np.abs(w).max(), err_msg=f"{what} {path}")
        rel = _rel_rms(g, w)
        assert rel <= rel_tol, (what, path, rel)
        worst = max(worst, rel)
    return worst


def test_loss_and_every_gradient_leaf_match_reference(model):
    cfg, params = model
    batch = _batch(cfg)
    (jloss, jmet), jgrads = jax.value_and_grad(
        lambda p: JT.loss_fn(cfg, p, jax.tree.map(jnp.asarray, batch)),
        has_aux=True)(params)
    tparams = _port_state(cfg, {"params": params})["params"]
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss, met, grads = TS.value_and_grad(cfg, tparams, tbatch)
    assert abs(float(loss) - float(jloss)) <= 1e-5
    assert float(met["moe_aux"]) == float(jmet["moe_aux"]) == 0.0
    assert float(met["ce"]) == float(loss)
    _compare_trees(cfg, jgrads, grads, GRAD_ABS, GRAD_REL_RMS, "grad")
    assert all(bool(g.abs().sum() > 0) for g in tree.leaves(grads))


@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "whisper-small",
                                  "gemma-7b", "gemma2-27b", "qwen1.5-110b",
                                  "chameleon-34b"])
def test_rglru_and_encoder_loss_and_gradients_match_reference(arch):
    """recurrentgemma-9b (the RG-LRU scan's gradient from autograd, ring
    caches play no part in training), whisper-small (the encoder, its
    cross-attention and learned positions, with seeded frames) and the
    dense variants — gemma-7b (MHA at head_dim 16 here, GeGLU, scaled
    embeddings), gemma2-27b (a local and a global layer in each period
    with window 8 under 32 tokens, the attention and final-logit
    softcaps, post-norms), qwen1.5-110b (GQA with qkv bias) and
    chameleon-34b (qk-norm): the loss and every gradient leaf against
    ``jax.grad`` of the reference's ``loss_fn``, with remat on as
    configured."""
    cfg = reduced(get_config(arch))
    if arch == "gemma2-27b":
        kinds = {s.attn_kind for s in cfg.all_specs}
        assert kinds == {"local", "global"} and cfg.attn_softcap > 0 \
            and cfg.logit_softcap > 0 and cfg.sliding_window < 32
    params = JT.init_params(cfg, jax.random.PRNGKey(3))
    batch = _batch(cfg, seed=3)
    if cfg.encoder is not None:
        batch["frames"] = (np.random.default_rng(3).standard_normal(
            (4, cfg.encoder.num_frames, cfg.d_model)) * 0.5).astype(np.float32)
    (jloss, _), jgrads = jax.value_and_grad(
        lambda p: JT.loss_fn(cfg, p, jax.tree.map(jnp.asarray, batch)),
        has_aux=True)(params)
    tparams = _port_state(cfg, {"params": params})["params"]
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    assert cfg.remat
    loss, _, grads = TS.value_and_grad(cfg, tparams, tbatch)
    assert abs(float(loss) - float(jloss)) <= 1e-5
    _compare_trees(cfg, jgrads, grads, GRAD_ABS, GRAD_REL_RMS, "grad")
    assert all(bool(g.abs().sum() > 0) for g in tree.leaves(grads))


@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "whisper-small"])
def test_rglru_and_encoder_checkpoints_are_the_references_file_for_file(
        tmp_path, arch):
    """The RG-LRU leaves (``lam`` float32 in bf16 params), the encoder's
    stacked blocks and ``pos_embed`` checkpoint to the reference's files
    and restore in the port."""
    cfg = dataclasses.replace(reduced(get_config(arch)),
                              param_dtype="bfloat16")
    jopt = JS.make_optimizer(cfg)
    jstate = JS.init_train_state(cfg, jax.random.PRNGKey(2), jopt)
    tstate = _port_state(cfg, jstate)
    jd, td = str(tmp_path / "jax"), str(tmp_path / "torch")
    JCk.save_checkpoint(jd, 1, jstate)
    TCk.save_checkpoint(td, 1, convert.stack_state(cfg, tstate))
    assert _manifest(td, 1) == _manifest(jd, 1)
    for rec in _manifest(jd, 1)["leaves"]:
        assert (Path(jd, "step_00000001", rec["file"]).read_bytes()
                == Path(td, "step_00000001", rec["file"]).read_bytes()), \
            rec["path"]
    stacked, _, _ = TCk.restore_checkpoint(jd,
                                           convert.stack_state(cfg, tstate))
    back = convert.unstack_state(cfg, stacked)
    for (p, a), (_, b) in zip(tree.flatten_with_paths(back),
                              tree.flatten_with_paths(tstate)):
        assert a.dtype == b.dtype and torch.equal(a, b), p


def test_remat_changes_nothing_but_memory(model):
    cfg, params = model
    tparams = _port_state(cfg, {"params": params})["params"]
    tbatch = {k: torch.from_numpy(v) for k, v in _batch(cfg).items()}
    assert cfg.remat
    on = TS.value_and_grad(cfg, tparams, tbatch)
    off = TS.value_and_grad(dataclasses.replace(cfg, remat=False), tparams,
                            tbatch)
    assert torch.equal(on[0], off[0])
    for a, b in zip(tree.leaves(on[2]), tree.leaves(off[2])):
        assert torch.equal(a, b)


@pytest.mark.parametrize("accum", [1, 2])
def test_train_steps_match_reference(model, accum):
    """Two AdamW steps (warmup-cosine, weight decay 0.1, clip 1.0) from
    carried weights.  Parameters within 2e-6 + 1e-4·|p|: an AdamW step is
    lr·m/(sqrt(v)+eps), so a float32 difference in a gradient moves the
    step by its own relative size (~1e-6 of lr = 3e-4 here) — except
    where the gradient is ~0 and its sign is noise, which could move a
    parameter by up to lr; the bound would show that."""
    cfg, params = model
    cfg = dataclasses.replace(cfg, accum_steps=accum)
    jopt = JS.make_optimizer(cfg, peak_lr=3e-4, total_steps=20)
    topt = TS.make_optimizer(cfg, peak_lr=3e-4, total_steps=20)
    jstate = {"params": params, "opt": jopt.init(params)}
    tstate = _port_state(cfg, jstate)
    jstep = jax.jit(JS.make_train_step(cfg, jopt))
    tstep = TS.make_train_step(cfg, topt)
    for i in range(2):
        batch = _batch(cfg, seed=i)
        jstate, jm = jstep(jstate, jax.tree.map(jnp.asarray, batch))
        tstate, tm = tstep(tstate, {k: torch.from_numpy(v)
                                    for k, v in batch.items()})
        for k in ("loss", "grad_norm", "ce", "moe_aux"):
            assert abs(float(tm[k]) - float(jm[k])) <= 1e-5 * max(
                1.0, abs(float(jm[k]))), (i, k)
    _compare_trees(cfg, jstate["params"], tstate["params"], 2e-6, 1e-4,
                   "params")
    assert int(tstate["opt"].step) == int(jstate["opt"].step) == 2


def test_donated_train_steps_give_the_same_bits(model):
    """``make_train_step(donate=True)`` (the trainer's, as the reference
    donates its state) writes the new state into the old one's tensors and
    gives the bits of the functional step, over two steps."""
    cfg, params = model
    opt = TS.make_optimizer(cfg, peak_lr=3e-4, total_steps=20)
    fstate = _port_state(cfg, {"params": params})
    fstate = {"params": fstate["params"], "opt": opt.init(fstate["params"])}
    dstate = {"params": tree.map(torch.clone, fstate["params"]),
              "opt": opt.init(fstate["params"])}
    held = tree.leaves(dstate)
    fstep = TS.make_train_step(cfg, opt)
    dstep = TS.make_train_step(cfg, opt, donate=True)
    for i in range(2):
        batch = {k: torch.from_numpy(v) for k, v in _batch(cfg, seed=i).items()}
        fstate, fm = fstep(fstate, batch)
        dstate, dm = dstep(dstate, batch)
        assert float(fm["loss"]) == float(dm["loss"])
    for path, a, b, h in zip(tree.flatten_with_paths(dstate),
                             tree.leaves(dstate), tree.leaves(fstate), held):
        assert torch.equal(a, b), path[0]
        if a.dim() > 0:
            assert a is h, path[0]


@pytest.mark.parametrize("scheme", ["int8", "topk"])
def test_compressed_step_matches_reference(model, scheme):
    cfg, params = model
    jopt = JS.make_optimizer(cfg, peak_lr=5e-3, total_steps=40)
    topt = TS.make_optimizer(cfg, peak_lr=5e-3, total_steps=40)
    jstate = JS.init_train_state(cfg, jax.random.PRNGKey(0), jopt,
                                 compression=scheme)
    tstate = _port_state(cfg, jstate)
    batch = _batch(cfg, seed=4)
    jstate, jm = jax.jit(JS.make_train_step(cfg, jopt, compression=scheme))(
        jstate, jax.tree.map(jnp.asarray, batch))
    tstate, tm = TS.make_train_step(cfg, topt, compression=scheme)(
        tstate, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert tm["wire_bytes"] == int(jm["wire_bytes"])
    assert abs(float(tm["loss"]) - float(jm["loss"])) <= 1e-5
    # compression itself is bit-equal (tests/test_torch_optimizer.py); here
    # its input is the gradient, and where a float32 difference of the
    # gradient straddles an int8 rounding boundary or the top-k threshold
    # one entry lands a quantum apart: allow one in a thousand entries
    want = convert.state_from_jax(cfg, {"params": _np(
        jstate["ef"].residual)})["params"]
    off = {tree.path_str(path): int((~np.isclose(
        g.numpy(), w.numpy(), rtol=1e-4, atol=1e-5)).sum())
        for (path, w), g in zip(tree.flatten_with_paths(want),
                                tree.leaves(tstate["ef"].residual))}
    n = sum(g.numel() for g in tree.leaves(tstate["ef"].residual))
    assert sum(off.values()) <= 1e-3 * n, (scheme, off)


# -- checkpoints -----------------------------------------------------------------

def _manifest(d, step):
    with open(os.path.join(d, f"step_{step:08d}", "manifest.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_checkpoint_is_the_references_file_for_file(tmp_path, dtype):
    """The same train state saved by both packages: identical manifests and
    identical array files (bfloat16 as its bits, as the reference writes
    it), and each package's checkpoint restores in the port."""
    cfg = dataclasses.replace(reduced(get_config("mamba2-370m")),
                              param_dtype=dtype, opt_state_bf16=True)
    jopt = JS.make_optimizer(cfg)
    jstate = JS.init_train_state(cfg, jax.random.PRNGKey(1), jopt,
                                 compression="int8")
    tstate = _port_state(cfg, jstate)
    jd, td = str(tmp_path / "jax"), str(tmp_path / "torch")
    JCk.save_checkpoint(jd, 3, jstate, extra={"data_step": 3})
    TCk.save_checkpoint(td, 3, convert.stack_state(cfg, tstate),
                        extra={"data_step": 3})
    assert _manifest(td, 3) == _manifest(jd, 3)
    for rec in _manifest(jd, 3)["leaves"]:
        a = Path(jd, "step_00000003", rec["file"]).read_bytes()
        b = Path(td, "step_00000003", rec["file"]).read_bytes()
        assert a == b, rec["path"]
    like = convert.stack_state(cfg, tstate)
    for d in (jd, td):
        stacked, step, extra = TCk.restore_checkpoint(d, like)
        assert step == 3 and extra == {"data_step": 3}
        back = convert.unstack_state(cfg, stacked)
        for (p, a), (_, b) in zip(tree.flatten_with_paths(back),
                                  tree.flatten_with_paths(tstate)):
            assert a.dtype == b.dtype and torch.equal(a, b), (d, p)


def test_checkpoints_cross_between_the_packages(tmp_path, model):
    """A reference run's checkpoint resumes in the port, and the port's in
    the reference: one step each way, then both continue identically."""
    cfg, params = model
    jopt = JS.make_optimizer(cfg, peak_lr=1e-3, total_steps=10)
    topt = TS.make_optimizer(cfg, peak_lr=1e-3, total_steps=10)
    jstep = jax.jit(JS.make_train_step(cfg, jopt))
    tstep = TS.make_train_step(cfg, topt)
    b0, b1 = _batch(cfg, seed=10), _batch(cfg, seed=11)
    jstate = {"params": params, "opt": jopt.init(params)}
    jstate, _ = jstep(jstate, jax.tree.map(jnp.asarray, b0))
    JCk.save_checkpoint(str(tmp_path / "j"), 1, jstate)
    # reference → port
    like = convert.stack_state(cfg, _port_state(cfg, jstate))
    stacked, step, _ = TCk.restore_checkpoint(str(tmp_path / "j"), like)
    tstate = convert.unstack_state(cfg, stacked)
    assert step == 1 and int(tstate["opt"].step) == 1
    # port → reference
    TCk.save_checkpoint(str(tmp_path / "t"), 1, convert.stack_state(
        cfg, tstate))
    jback, _, _ = JCk.restore_checkpoint(str(tmp_path / "t"), jstate)
    jback = jax.tree.map(jnp.asarray, jback)
    for a, b in zip(jax.tree.leaves(jback), jax.tree.leaves(jstate)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    jstate, jm = jstep(jback, jax.tree.map(jnp.asarray, b1))
    tstate, tm = tstep(tstate, {k: torch.from_numpy(v)
                                for k, v in b1.items()})
    assert abs(float(tm["loss"]) - float(jm["loss"])) <= 1e-5
    _compare_trees(cfg, jstate["params"], tstate["params"], 2e-6, 1e-4,
                   "params after the crossed step")


def test_checkpoint_gc_and_atomicity(tmp_path):
    d = str(tmp_path)
    state = {"params": {"w": torch.arange(6.0).reshape(2, 3)},
             "step": torch.tensor(7, dtype=torch.int32)}
    for s in (1, 2, 3, 4):
        TCk.save_checkpoint(d, s, state, extra={"data_step": s * 10})
    assert TCk.latest_step(d) == 4
    assert len([x for x in os.listdir(d) if x.startswith("step_")]) == 3
    os.makedirs(os.path.join(d, ".tmp_ckpt_crashed"))
    restored, step, extra = TCk.restore_checkpoint(d, state)
    assert step == 4 and extra["data_step"] == 40
    assert torch.equal(restored["params"]["w"], state["params"]["w"])
    assert restored["step"].dtype == torch.int32
    with pytest.raises(KeyError):
        TCk.restore_checkpoint(d, {"other": torch.zeros(1)})


# -- data pipeline, restarts, CLI ------------------------------------------------------

def test_token_source_bit_equal_and_loader_stops():
    for kw in ({"vocab_size": 1000, "seq_len": 16, "global_batch": 8,
                "num_hosts": 4}, {"vocab_size": 50280, "seq_len": 64,
                                  "global_batch": 2, "seed": 3}):
        js, ts = JP.TokenSource(JP.DataConfig(**kw)), \
            TP.TokenSource(TP.DataConfig(**kw))
        for step in (0, 1, 5, 1234):
            jb, tb = js.global_batch_at(step), ts.global_batch_at(step)
            for k in ("tokens", "labels"):
                assert tb[k].dtype == jb[k].dtype
                np.testing.assert_array_equal(tb[k], jb[k])
    loader = TP.PrefetchingLoader(TP.TokenSource(TP.DataConfig(
        vocab_size=100, seq_len=8, global_batch=4)), start_step=3)
    assert [next(loader)[0] for _ in range(4)] == [3, 4, 5, 6]
    loader.close()
    assert not loader._thread.is_alive()


def test_train_with_restarts_is_exactly_once(tmp_path):
    """A failure at step 6 after a checkpoint at step 4: the restart
    restores step 4 and takes batches 4-7 once each, in order, and ends
    where an uninterrupted run ends, bit for bit (CPU)."""
    cfg = reduced(get_config("mamba2-370m"))
    run = dict(cfg=cfg, total_steps=8, global_batch=2, seq_len=16,
               ckpt_every=4, device="cpu", log_every=100)
    out = TTrain.train_with_restarts(TTrain.TrainRun(
        **run, ckpt_dir=str(tmp_path / "ck"), fail_at_step=6))
    clean = TTrain.train(TTrain.TrainRun(**run))
    src = TP.TokenSource(TP.DataConfig(vocab_size=cfg.vocab_size,
                                       seq_len=16, global_batch=2))
    assert out["start_step"] == 4 and out["final_step"] == 8
    assert out["taken"] == [(s, int(src.batch_at(s, 0)["tokens"].sum()))
                            for s in range(4, 8)]
    assert [s for s, _ in clean["taken"]] == list(range(8))
    assert out["losses"] == clean["losses"][4:]
    for a, b in zip(tree.leaves(out["state"]), tree.leaves(clean["state"])):
        assert torch.equal(a, b)
    assert TCk.latest_step(str(tmp_path / "ck")) == 8


def test_train_cli_on_the_cpu(tmp_path):
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "mamba2-370m", "--reduced", "--steps", "3", "--batch", "2",
         "--seq", "16", "--device", "cpu", "--ckpt-dir",
         str(tmp_path / "ck")], capture_output=True, text=True, timeout=300,
        env={"PYTHONPATH": str(SRC), "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    assert "[train] done" in out.stdout
    assert TCk.latest_step(str(tmp_path / "ck")) == 3


def test_train_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    cfg = reduced(get_config("mamba2-370m"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TTrain.train(TTrain.TrainRun(cfg=cfg, total_steps=1,
                                     global_batch=2, seq_len=16))


# -- the kernels' autograd Functions (backward with a CPU stand-in) -------------------

@pytest.fixture
def stand_ins(monkeypatch):
    """The CUDA routes' Functions on CPU tensors: each forward kernel
    replaced by its plain twin (counted as a launch), the dispatchers
    routed through the Functions."""
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
                        fa_ops.KernelAttention.apply(q, k, v, causal, window,
                                                     softcap, scale))
    monkeypatch.setattr(ss_ops, "ssd", lambda x, dt, A, Bm, Cm, *, chunk=256:
                        ss_ops.KernelSSD.apply(x, dt, A, Bm, Cm, chunk))
    fa.reset_launches()
    ss.reset_launches()
    yield
    fa.reset_launches()
    ss.reset_launches()


def test_functions_give_the_plain_twins_gradient(stand_ins):
    g = torch.Generator().manual_seed(0)
    q = torch.randn(2, 4, 24, 16, generator=g, requires_grad=True)
    k = torch.randn(2, 2, 24, 16, generator=g, requires_grad=True)
    v = torch.randn(2, 2, 24, 16, generator=g, requires_grad=True)
    cot = torch.randn(2, 4, 24, 16, generator=g)
    for opts in ({"causal": True, "window": None, "softcap": 0.0},
                 {"causal": True, "window": 5, "softcap": 30.0}):
        out = fa_ops.KernelAttention.apply(q, k, v, opts["causal"],
                                           opts["window"], opts["softcap"],
                                           None)
        assert out.grad_fn is not None
        got = torch.autograd.grad(out, (q, k, v), cot)
        want = torch.autograd.grad(attention_ref(q, k, v, **opts), (q, k, v),
                                   cot)
        for a, b in zip(got, want):
            assert torch.isfinite(a).all()
            torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert fa.LAUNCHES["flash_attention"] == 2
    assert fa.RECOMPUTES["flash_attention"] == 2

    x = torch.randn(2, 32, 3, 16, generator=g, requires_grad=True)
    dt = torch.rand(2, 32, 3, generator=g).requires_grad_()
    A = (-torch.rand(3, generator=g) - 0.5).requires_grad_()
    Bm = torch.randn(2, 32, 16, generator=g, requires_grad=True)
    Cm = torch.randn(2, 32, 16, generator=g, requires_grad=True)
    y, h = ss_ops.KernelSSD.apply(x, dt, A, Bm, Cm, 16)
    assert y.grad_fn is not None and h.grad_fn is not None
    gy, gh = torch.randn_like(y), torch.randn_like(h)
    ins = (x, dt, A, Bm, Cm)
    for cot_h in (gh, None):                # the final state used or not
        outs = (y, h) if cot_h is not None else (y,)
        cots = (gy, gh) if cot_h is not None else (gy,)
        got = torch.autograd.grad(outs, ins, cots, retain_graph=True)
        ry, rh = ssd_ref(*ins, 16)
        want = torch.autograd.grad((ry, rh) if cot_h is not None else (ry,),
                                   ins, cots)
        for a, b in zip(got, want):
            assert torch.isfinite(a).all()
            torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert ss.LAUNCHES["ssd_scan"] == 1 and ss.RECOMPUTES["ssd_scan"] == 2


def test_train_step_through_the_functions_matches_plain_autograd(model,
                                                                 stand_ins):
    """The whole model's gradient with the mixers behind the Functions (as
    on the card) equals plain autograd's, and the kernels launch twice a
    layer under remat (forward, recompute) with one recompute each."""
    cfg, params = model
    tparams = _port_state(cfg, {"params": params})["params"]
    tbatch = {k: torch.from_numpy(v) for k, v in _batch(cfg).items()}
    loss, _, grads = TS.value_and_grad(cfg, tparams, tbatch)
    n = cfg.num_layers
    if cfg.ssd:
        assert (ss.LAUNCHES["ssd_scan"], ss.RECOMPUTES["ssd_scan"]) == \
            (2 * n, n)
    else:
        assert (fa.LAUNCHES["flash_attention"],
                fa.RECOMPUTES["flash_attention"]) == (2 * n, n)
    ss.reset_launches()
    fa.reset_launches()
    with torch.no_grad():                   # serving: no recompute
        TT.forward(cfg, tparams, tbatch["tokens"])
    assert ss.RECOMPUTES["ssd_scan"] == fa.RECOMPUTES["flash_attention"] == 0
    (jloss, _), jgrads = jax.value_and_grad(
        lambda p: JT.loss_fn(cfg, p, jax.tree.map(jnp.asarray, {
            k: v.numpy() for k, v in tbatch.items()})), has_aux=True)(params)
    assert abs(float(loss) - float(jloss)) <= 1e-5
    _compare_trees(cfg, jgrads, grads, GRAD_ABS, GRAD_REL_RMS,
                   "grad through the Functions")


# -- a CPU dry run of chip_smoke.py phase 12 (b)-(c) ------------------------------------

@pytest.mark.parametrize("arch", ["mamba2-370m", "internlm2-1.8b"])
def test_phase12_dry_run_predicts_its_launches(tmp_path, stand_ins, arch):
    """Phase 12's LM steps on CPU tensors at the configs' full depth and
    narrow width, the kernels' Functions on their CPU stand-ins: the
    launches and recomputes counted in one loss/backward and per train
    step are those phase 12 asserts (``P12_LAUNCHES``) — they depend on
    the depth and remat, not the width; the gradient check, the falling
    loss and the int8 wire bytes run as on the card (the restart, 18 more
    steps at this depth, runs at reduced depth below)."""
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    import chip_smoke
    from repro_torch.configs import get_config as tget_config
    from repro_torch.configs.reduced import reduced as treduced
    full = tget_config(arch)
    cfg = dataclasses.replace(treduced(full), num_layers=full.num_layers)
    env = chip_smoke.p12_env(torch, np, "cpu", "the CPU (dry run)")
    mamba = cfg.ssd is not None
    out = chip_smoke.p12_lm(env, cfg, arch, 2, 32, 3, tmp_path,
                            restart=False, int8=mamba)
    assert out["per_step"] == chip_smoke.P12_LAUNCHES[arch]
    assert out["layers"] == full.num_layers
    assert out["losses"][-1] < out["losses"][0]
    assert ("wire_bytes" in out) == mamba


def test_phase12_restart_check_on_the_cpu(tmp_path, stand_ins, monkeypatch):
    """Phase 12's restart check (``p12_lm`` with ``restart=True``) at
    reduced depth, the Functions on their CPU stand-ins: it resumes at
    the checkpoint with each later batch once and finds the restarted run
    equal to an uninterrupted one in every loss and state leaf; its launch
    counts are the full-depth ones scaled to this depth."""
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    import chip_smoke
    from repro_torch.configs import get_config as tget_config
    from repro_torch.configs.reduced import reduced as treduced
    arch = "mamba2-370m"
    full, cfg = tget_config(arch), treduced(tget_config(arch))
    scaled = {k: v * cfg.num_layers // full.num_layers
              for k, v in chip_smoke.P12_LAUNCHES[arch].items()}
    monkeypatch.setitem(chip_smoke.P12_LAUNCHES, arch, scaled)
    env = chip_smoke.p12_env(torch, np, "cpu", "the CPU (dry run)")
    out = chip_smoke.p12_lm(env, cfg, arch, 2, 16, 2, tmp_path,
                            restart=True, int8=False)
    assert out["per_step"] == scaled
    assert out["restart_loss_diff"] == out["restart_state_diff"] == 0.0


# -- a CPU dry run of chip_smoke.py phase 17 (a)-(b) ------------------------------------

@pytest.mark.parametrize("arch", ["whisper-small", "recurrentgemma-9b",
                                  "deepseek-v2-236b", "gemma-7b",
                                  "gemma2-27b", "qwen1.5-110b",
                                  "chameleon-34b"])
def test_phase17_dry_run_predicts_its_launches_and_bytes(tmp_path,
                                                        stand_ins, arch):
    """Phase 17's (a) float32 check and (b) train steps and ``train`` with
    a checkpoint on CPU tensors at the phase's depths and layer kinds and
    narrow width, the kernels' Functions on their CPU stand-ins: the flash
    launches and recomputes of (a) and per step of (b) are those phase 17
    asserts (``P17_LAUNCHES``), the loss falls on the repeated batch, the
    checkpoint holds the reckoned bytes, and the byte reckoning counts the
    parameters, moments and gradients the step really holds and the
    stacked state the checkpoint writes; at full width the reckoning of
    (a) and (b) stays under the phase's limit."""
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    import chip_smoke as C
    from repro_torch.configs import get_config as tget_config
    from repro_torch.configs.reduced import reduced as treduced
    full = tget_config(arch)
    layers, B, S = {a: (n, b, s) for a, n, b, s in C.P17_LM}[arch]
    big = C.p17_reckon(torch, C.p17_config(full, layers), B, S)
    # the checkpoint sets deepseek-v2's peak: (b) writes it there only
    assert C.p17_checkpoints(big) == (arch == "deepseek-v2-236b")
    check = C.p17_reckon(torch, C.p17_config(full, C.p17_period(full),
                                             "float32"), *C.P17_CHECK,
                         optimizer=False)
    assert max(big["total"], check["total"]) <= C.P17_BYTES_LIMIT

    small = treduced(full)
    env = C.p12_env(torch, np, "cpu", "the CPU (dry run)")
    out = C.p17_check(env, small, arch)
    assert out["counts"] == C.P17_LAUNCHES[arch]["check"]
    cfg = C.p17_config(small, layers)
    assert cfg.num_layers == layers and [s.mixer for s in cfg.all_specs] == \
        [s.mixer for s in C.p17_config(full, layers).all_specs]
    out = C.p17_steps(env, cfg, arch, 2, 32)
    assert out["per_step"] == C.P17_LAUNCHES[arch]["step"]
    assert out["losses"][-1] < out["losses"][0]
    trained = C.p17_train(env, cfg, arch, 2, 32, tmp_path, checkpoint=True)
    assert trained["per_step"] == C.P17_LAUNCHES[arch]["step"]
    assert not list(tmp_path.iterdir())         # the checkpoint removed
    opt = TS.make_optimizer(cfg)
    state = TS.init_train_state(cfg, torch.Generator().manual_seed(0), opt,
                                device="cpu")
    held = tree.leaves(state["params"])
    nbytes = sum(t.numel() * t.element_size() for t in
                 held + tree.leaves(state["opt"].m)
                 + tree.leaves(state["opt"].v)) + \
        sum(t.numel() * t.element_size() for t in held)     # gradients
    rk = out["reckoned"]
    assert rk["state"] == nbytes
    assert rk["params"] == sum(t.numel() for t in held)
    assert rk["largest_leaf"] == max(t.numel() for t in held)
    stacked = [t for t in tree.leaves(convert.stack_state(cfg, state))
               if t.dim() > 0]                  # all but the step count
    assert rk["checkpoint"] == sum(t.numel() * t.element_size()
                                   for t in stacked)
    own = {id(t) for t in tree.leaves(state)}
    assert rk["stacked_copy"] == sum(t.numel() * t.element_size()
                                     for t in stacked if id(t) not in own)
    assert rk["total"] == max(rk["step"],
                              rk["checkpoint"] + rk["stacked_copy"])
