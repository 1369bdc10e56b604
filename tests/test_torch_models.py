"""The torch port's LM serving path against the JAX package on the CPU.

Every config the port runs, reduced, in float32 — among them internlm2-1.8b
(dense GQA attention), mamba2-370m (SSD), chameleon-34b (qk-norm; its
``vq`` frontend is a stub in both packages), llama4-maverick (MoE every
other layer, local and global NoPE layers) and deepseek-v2 (MLA, a dense
prefix layer, then MoE; the MLA latent caches are compared too),
recurrentgemma-9b (RG-LRU layers and local attention over ring-buffered
caches of ``window`` = 8 slots) and whisper-small (an encoder over 16
seeded random frames, cross-attention, learned positions; each layer's
cross K/V compared with its slice of the reference's stacked
``cache["cross"]``): weights from the JAX ``T.init_params`` carried across
by ``params_from_jax``; prefill and three decode steps compared on logits
and caches within 1e-4, and greedy ``serve_batch`` tokens compared
exactly.
In the port the prefill mixers go through the kernels' plain versions
(CPU tensors); in the reference they are the jnp paths the model layers
call.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config  # noqa: E402
from repro.configs.reduced import reduced  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.configs import get_config as tget_config  # noqa: E402
from repro_torch.configs.reduced import reduced as treduced  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402

ARCHS = ["internlm2-1.8b", "mamba2-370m", "gemma-7b", "gemma2-27b",
         "qwen1.5-110b", "chameleon-34b", "llama4-maverick-400b-a17b",
         "deepseek-v2-236b", "recurrentgemma-9b", "whisper-small"]
TOL = 1e-4


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _frames(cfg, B, seed=0):
    """Seeded frame embeddings (B, F, D) for an encoder config, else
    None, as numpy for both packages."""
    if cfg.encoder is None:
        return None
    return (np.random.default_rng(seed).standard_normal(
        (B, cfg.encoder.num_frames, cfg.d_model)) * 0.5).astype(np.float32)


def _j(a):
    return None if a is None else jnp.asarray(a)


def _t(a):
    return None if a is None else torch.from_numpy(a)


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    cfg = reduced(get_config(request.param))
    params = JT.init_params(cfg, jax.random.PRNGKey(0))
    tparams = convert.params_from_jax(cfg, _np(params))
    return cfg, params, tparams


def _close(got, want, what):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=TOL,
                               rtol=TOL, err_msg=what)


def _check_caches(cfg, jcache, tcache, what):
    """Per layer; the reference's stacked cross K/V ``cache["cross"]``
    (num_layers, B, F, KV, hd) mapped onto each layer's ``["cross"]``."""
    jcache = _np(jcache)
    jlayers = convert.unstack_layers(cfg, jcache)
    assert len(jlayers) == len(tcache) == cfg.num_layers
    for i, (jl, tl) in enumerate(zip(jlayers, tcache)):
        if "cross" in jcache:
            jl = dict(jl, cross={w: jcache["cross"][w][i] for w in "kv"})
        assert sorted(jl) == sorted(tl)
        for key in jl:
            pairs = ([(f"{key}/{w}", tl[key][w], jl[key][w]) for w in "kv"]
                     if key == "cross" else [(key, tl[key], jl[key])])
            for name, got, want in pairs:
                assert tuple(got.shape) == want.shape, (what, i, name)
                _close(got.numpy(), want, f"{what} layer {i} {name}")


def test_port_config_registry_matches_reference():
    from repro.configs import list_archs
    from repro_torch.configs import list_archs as tlist_archs
    assert tlist_archs() == list_archs()
    for name in list_archs():
        want, got = get_config(name), tget_config(name)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert (dataclasses.asdict(treduced(got))
                == dataclasses.asdict(reduced(want)))
    assert tget_config("internlm2-1.8b").param_count() == 1_889_533_952
    assert tget_config("mamba2-370m").param_count() == 367_788_032


def test_prefill_and_decode_match_reference(model):
    cfg, params, tparams = model
    B, S, steps = 2, 24, 3
    rng = np.random.default_rng(7)
    prompt = rng.integers(0, cfg.vocab_size, (B, S), dtype=np.int32)
    feed = rng.integers(0, cfg.vocab_size, (B, steps), dtype=np.int32)
    frames = _frames(cfg, B)

    jlogits, jcache = JT.prefill(cfg, params, jnp.asarray(prompt),
                                 frames=_j(frames), cache_len=S + steps)
    with torch.inference_mode():
        tlogits, tcache = TT.prefill(cfg, tparams, torch.from_numpy(prompt),
                                     frames=_t(frames), cache_len=S + steps)
    assert tuple(tlogits.shape) == (B, cfg.padded_vocab)
    _close(tlogits.numpy(), jlogits, "prefill logits")
    _check_caches(cfg, jcache, tcache, "prefill cache")

    for i in range(steps):
        tok = feed[:, i:i + 1]
        jlogits, jcache = JT.decode_step(cfg, params, jcache,
                                         jnp.asarray(tok), jnp.int32(S + i))
        with torch.inference_mode():
            tlogits, tcache = TT.decode_step(cfg, tparams, tcache,
                                             torch.from_numpy(tok), S + i)
        _close(tlogits.numpy(), jlogits, f"decode step {i} logits")
        _check_caches(cfg, jcache, tcache, f"decode step {i} cache")


def test_serve_batch_greedy_tokens_equal_reference(model):
    cfg, params, tparams = model
    prompts = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 20),
                                                dtype=np.int32)
    frames = _frames(cfg, 2, seed=3)
    jgen, _ = jserve.serve_batch(cfg, params, prompts, 6, frames=_j(frames))
    tgen, stats = tserve.serve_batch(cfg, tparams, prompts, 6,
                                     frames=_t(frames), device="cpu")
    assert stats["device"] == "cpu"
    np.testing.assert_array_equal(tgen, jgen)


def test_prefill_pads_ssd_to_a_chunk_multiple(model):
    """A prompt that is not a chunk multiple (mamba2 reduced: chunk 16) and
    one that is shorter than a chunk take the padded scan."""
    cfg, params, tparams = model
    for S in (5, 21):
        prompt = np.random.default_rng(S).integers(
            0, cfg.vocab_size, (1, S), dtype=np.int32)
        frames = _frames(cfg, 1, seed=S)
        jlogits, jcache = JT.prefill(cfg, params, jnp.asarray(prompt),
                                     frames=_j(frames))
        with torch.inference_mode():
            tlogits, tcache = TT.prefill(cfg, tparams,
                                         torch.from_numpy(prompt),
                                         frames=_t(frames))
        _close(tlogits.numpy(), jlogits, f"prefill S={S}")
        _check_caches(cfg, jcache, tcache, f"prefill S={S} cache")


def test_params_from_jax_bf16_round_trip_is_bit_exact():
    cfg = dataclasses.replace(reduced(get_config("internlm2-1.8b")),
                              param_dtype="bfloat16")
    params = _np(JT.init_params(cfg, jax.random.PRNGKey(1)))
    tparams = convert.params_from_jax(cfg, params)
    jlayers = convert.unstack_layers(cfg, params)
    pairs = [(params["embed"]["table"], tparams["embed"]["table"]),
             (params["unembed"]["table"], tparams["unembed"]["table"])]
    for jl, tl in zip(jlayers, tparams["layers"]):
        pairs += [(jl["attn"][w]["w"], tl["attn"][w]["w"])
                  for w in ("wq", "wk", "wv", "wo")]
        pairs += [(jl["ffn"][w]["w"], tl["ffn"][w]["w"])
                  for w in ("w_in", "w_gate", "w_out")]
    for want, got in pairs:
        assert want.dtype.name == "bfloat16"
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                      want.view(np.int16))


@pytest.mark.parametrize("name,field,value", [
    ("llama4-maverick-400b-a17b", "windowed_local_cache", True),  # ring cache
    ("deepseek-v2-236b", "positional", "learned"),
    ("recurrentgemma-9b", None, None),                 # RG-LRU
    ("whisper-small", None, None),                     # encoder
    ("internlm2-1.8b", "positional", "learned"),
])
def test_variant_configs_match_reference(name, field, value):
    """Configs the port once refused: prefill over a prompt longer than the
    reduced window (8) and decode steps that pass it, logits and caches
    against the reference's."""
    change = {field: value} if field else {}
    cfg = reduced(dataclasses.replace(get_config(name), **change))
    tcfg = treduced(dataclasses.replace(tget_config(name), **change))
    assert len(TT.init_cache(tcfg, 1, 4, "cpu")) == cfg.num_layers
    params = JT.init_params(cfg, jax.random.PRNGKey(2))
    tparams = convert.params_from_jax(cfg, _np(params))
    B, S, steps = 2, 11, 2
    rng = np.random.default_rng(17)
    prompt = rng.integers(0, cfg.vocab_size, (B, S), dtype=np.int32)
    frames = _frames(cfg, B, seed=17)
    jlogits, jcache = JT.prefill(cfg, params, jnp.asarray(prompt),
                                 frames=_j(frames), cache_len=S + steps)
    with torch.inference_mode():
        tlogits, tcache = TT.prefill(cfg, tparams, torch.from_numpy(prompt),
                                     frames=_t(frames), cache_len=S + steps)
    _close(tlogits.numpy(), jlogits, f"{name} prefill logits")
    _check_caches(cfg, jcache, tcache, f"{name} prefill cache")
    for i in range(steps):
        tok = rng.integers(0, cfg.vocab_size, (B, 1), dtype=np.int32)
        jlogits, jcache = JT.decode_step(cfg, params, jcache,
                                         jnp.asarray(tok), jnp.int32(S + i))
        with torch.inference_mode():
            tlogits, tcache = TT.decode_step(cfg, tparams, tcache,
                                             torch.from_numpy(tok), S + i)
        _close(tlogits.numpy(), jlogits, f"{name} decode step {i} logits")
        _check_caches(cfg, jcache, tcache, f"{name} decode step {i} cache")


@pytest.mark.parametrize("name", ["recurrentgemma-9b",
                                  "llama4-maverick-400b-a17b"])
def test_ring_cache_short_prompt_then_decode_across_the_wrap(name):
    """A prompt shorter than the window (5 < 8) fills slots [0, 5) of the
    ring; eight decode steps then write slots 5..7 and wrap to 0..4."""
    cfg = reduced(dataclasses.replace(get_config(name),
                                      windowed_local_cache=True))
    params = JT.init_params(cfg, jax.random.PRNGKey(4))
    tparams = convert.params_from_jax(cfg, _np(params))
    B, S, steps = 2, 5, 8
    rng = np.random.default_rng(5)
    prompt = rng.integers(0, cfg.vocab_size, (B, S), dtype=np.int32)
    jlogits, jcache = JT.prefill(cfg, params, jnp.asarray(prompt),
                                 cache_len=S + steps)
    with torch.inference_mode():
        tlogits, tcache = TT.prefill(cfg, tparams, torch.from_numpy(prompt),
                                     cache_len=S + steps)
    ring = [c["k"].shape[1] for c, spec in zip(tcache, cfg.all_specs)
            if spec.mixer == "attn" and spec.attn_kind == "local"]
    assert ring and set(ring) == {cfg.sliding_window}
    _check_caches(cfg, jcache, tcache, f"{name} prefill cache")
    for i in range(steps):
        tok = rng.integers(0, cfg.vocab_size, (B, 1), dtype=np.int32)
        jlogits, jcache = JT.decode_step(cfg, params, jcache,
                                         jnp.asarray(tok), jnp.int32(S + i))
        with torch.inference_mode():
            tlogits, tcache = TT.decode_step(cfg, tparams, tcache,
                                             torch.from_numpy(tok), S + i)
        _close(tlogits.numpy(), jlogits, f"{name} decode step {i} logits")
    _check_caches(cfg, jcache, tcache, f"{name} cache after the wrap")


def test_unknown_kinds_raise():
    cfg = treduced(tget_config("internlm2-1.8b"))
    for field, value, what in (("positional", "alibi", "positions"),
                               ("pattern", (dataclasses.replace(
                                   cfg.pattern[0], mixer="lstm"),), "mixer"),
                               ("pattern", (dataclasses.replace(
                                   cfg.pattern[0], ffn="glu2"),), "ffn")):
        with pytest.raises(ValueError, match=what):
            TT.init_cache(dataclasses.replace(cfg, **{field: value}), 1, 4,
                          "cpu")


def test_train_forward_matches_reference(model):
    """The full-sequence forward (no cache) over every position."""
    cfg, params, tparams = model
    tokens = np.random.default_rng(11).integers(0, cfg.vocab_size, (2, 19),
                                                dtype=np.int32)
    frames = _frames(cfg, 2, seed=11)
    jlogits, _, _ = JT.forward(cfg, params, jnp.asarray(tokens),
                               frames=_j(frames))
    with torch.inference_mode():
        tlogits, tcache = TT.forward(cfg, tparams, torch.from_numpy(tokens),
                                     frames=_t(frames))
    assert tcache is None
    _close(tlogits.numpy(), jlogits, "train forward logits")


# -- layers: the same inputs through the reference's and the port's ----------

from repro.models import layers as JL  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402


def _pair(*shape, seed=0, scale=1.0):
    a = (np.random.default_rng(seed).standard_normal(shape) * scale
         ).astype(np.float32)
    return jnp.asarray(a), torch.from_numpy(a)


@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
def test_norms_match_reference(kind):
    jx, tx = _pair(3, 5, 32, seed=1, scale=3.0)
    js, ts = _pair(32, seed=2, scale=0.1)
    jb, tb = _pair(32, seed=3)
    jp = {"scale": js, "bias": jb} if kind == "layernorm" else {"scale": js}
    tp = {"scale": ts, "bias": tb} if kind == "layernorm" else {"scale": ts}
    _close(TL.norm_apply(kind, tp, tx).numpy(), JL.norm_apply(kind, jp, jx),
           kind)


@pytest.mark.parametrize("offset", [0, 37])
def test_rope_matches_reference(offset):
    jx, tx = _pair(2, 6, 4, 16, seed=4)
    pos = np.arange(6)[None, :] + offset
    _close(TL.apply_rope(tx, torch.from_numpy(pos), 1e6).numpy(),
           JL.apply_rope(jx, jnp.asarray(pos), 1e6), "rope")


@pytest.mark.parametrize("window,cap,kv_len", [(None, 0.0, 9), (4, 0.0, 12),
                                              (None, 20.0, 7)])
def test_decode_sdpa_matches_reference(window, cap, kv_len):
    """Decode attention over a cache longer than its valid prefix: GQA
    groups, q offset, window and softcap as the reference masks them."""
    jq, tq = _pair(2, 1, 4, 16, seed=5)
    jk, tk_ = _pair(2, 12, 2, 16, seed=6)
    jv, tv = _pair(2, 12, 2, 16, seed=7)
    want = JL.sdpa(jq, jk, jv, causal=True, window=window, attn_softcap=cap,
                   q_offset=kv_len - 1, kv_len=jnp.int32(kv_len))
    got = TL.sdpa(tq, tk_, tv, causal=True, window=window, attn_softcap=cap,
                  q_offset=kv_len - 1, kv_len=kv_len)
    _close(got.numpy(), want, "decode sdpa")


def test_cross_entropy_matches_reference():
    jl, tl = _pair(2, 5, 33, seed=8, scale=4.0)
    labels = np.random.default_rng(9).integers(0, 33, (2, 5))
    _close(TL.cross_entropy(tl, torch.from_numpy(labels)).numpy(),
           JL.cross_entropy(jl, jnp.asarray(labels)), "cross entropy")


def test_ssd_block_hands_the_kernel_aligned_views(monkeypatch):
    """At mamba2-370m's widths in bf16 the SSD mixer hands the scan x, B
    and C as in-place slices of the convolution output (rows of 2304
    elements, at element offsets 0, 2048 and 2176: 0, 4096 and 4352 bytes),
    and they pass the bf16 kernel's 16-B alignment checks, so the serving
    path never meets that error.  The wrapper gets as far as its device
    check on these CPU tensors."""
    from repro_torch.kernels.ssd_scan import ssd_scan as tk
    from repro_torch.models import ssd as tssd
    cfg = tget_config("mamba2-370m")
    s = cfg.ssd
    gen = torch.Generator().manual_seed(0)
    p = tssd.ssd_init(gen, cfg.d_model, d_inner=s.d_inner, state=s.state,
                      nheads=s.nheads, conv_width=s.conv_width,
                      dtype=torch.bfloat16)
    seen = []
    real = tssd.ssd_ops.ssd

    def spy(*args, chunk):
        seen.append(args)
        return real(*args, chunk=chunk)
    monkeypatch.setattr(tssd.ssd_ops, "ssd", spy)
    x = torch.randn((1, s.chunk, cfg.d_model), generator=gen).bfloat16()
    tssd.ssd_block(p, x, d_inner=s.d_inner, state=s.state, nheads=s.nheads,
                   chunk=s.chunk)
    (xs, dt, A, Bm, Cm), = seen
    row = s.d_inner + 2 * s.state
    assert xs.stride() == (s.chunk * row, row, s.d_inner // s.nheads, 1)
    assert Bm.stride() == Cm.stride() == (s.chunk * row, row, 1)
    assert [t.data_ptr() - xs.data_ptr() for t in (xs, Bm, Cm)] \
        == [0, 4096, 4352]
    with pytest.raises(ValueError, match="CUDA tensor"):
        tk.check_inputs(xs, dt, A, Bm, Cm, s.chunk)


@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "whisper-small"])
def test_phase14_decode_check_dry_run(arch):
    """``chip_smoke.py`` phase 14's decode-against-prefill check on the CPU
    at ``reduced()`` size in float32, with the reference's weights: the
    ring (window 8) wraps during the 10 decode steps after a prompt of 6,
    and whisper's decode reads its cached cross K/V; steps 0 and 9 within
    1e-3 of the logits' max-abs."""
    import sys
    from pathlib import Path
    root = str(Path(__file__).resolve().parents[1])
    if root not in sys.path:
        sys.path.insert(0, root)
    import chip_smoke
    cfg = reduced(get_config(arch))
    tparams = convert.params_from_jax(
        cfg, _np(JT.init_params(cfg, jax.random.PRNGKey(14))))
    frames = _t(_frames(cfg, 2, seed=14))
    worst = chip_smoke.p14_decode_check(torch, np, TT, cfg, tparams,
                                        (2, 6, 10), "float32", frames=frames)
    assert 0 <= worst <= 1e-3
