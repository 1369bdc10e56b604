"""The torch port's dry run (``launch/dryrun.py``), its counting mode
(``launch/op_analysis.py``), its mesh (``launch/mesh.py``) and the two
advisor variants it scores (flash decode, the "dots" remat policy),
against the JAX package.

The counting mode must count a product's 2·M·N·K and a collective's bytes
exactly, on local shards.  The per-device dot FLOPs of a decode cell on a
(2, 2) mesh, times four (the port splits each product four ways), must
equal the reference's ``hlo_analysis`` of the same cell on four host
devices, which XLA runs replicated (a subprocess); HBM and collective
bytes are printed beside each other but not held equal: the reference counts XLA's
fusion boundaries and the collectives its SPMD partitioner chose, the
port every eager op's inputs and outputs and the collectives DTensor
chose.  Every process group a test starts is a fake one that
``fake_world`` destroys, or lives in a subprocess.
"""

import dataclasses
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs.reduced import reduced as jreduced  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch import tree  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import ShapeSpec  # noqa: E402
from repro_torch.configs.reduced import reduced  # noqa: E402
from repro_torch.launch import dryrun, op_analysis  # noqa: E402
from repro_torch.launch import steps as TS  # noqa: E402
from repro_torch.launch.mesh import fake_world, make_mesh  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402

SRC = Path(__file__).resolve().parents[1] / "src"
#: the keys of the reference's record, less ``xla_cost_analysis_once``
REFERENCE_KEYS = {
    "arch", "shape", "mesh", "chips", "kind", "extra_cfg", "variant",
    "flops_per_device", "bytes_per_device", "collective_bytes_per_device",
    "collectives", "compute_s", "memory_s", "collective_s", "bottleneck",
    "model_flops_global", "useful_flop_ratio", "memory_analysis",
    "compile_s"}


# -- the counting mode ---------------------------------------------------------

@pytest.mark.parametrize("op,shapes,flops", [
    ("mm", [(7, 5), (5, 3)], 2 * 7 * 5 * 3),
    ("bmm", [(4, 7, 5), (4, 5, 3)], 2 * 4 * 7 * 5 * 3),
    ("addmm", [(3,), (7, 5), (5, 3)], 2 * 7 * 5 * 3),
    ("baddbmm", [(4, 7, 3), (4, 7, 5), (4, 5, 3)], 2 * 4 * 7 * 5 * 3)])
def test_counting_mode_counts_a_product_exactly(op, shapes, flops):
    args = [torch.empty(s, device="meta") for s in shapes]
    out, t = op_analysis.count(getattr(torch, op), *args)
    assert t.flops == flops
    assert t.hbm_bytes == 4 * (sum(np.prod(s) for s in shapes)
                               + out.numel())
    assert t.collectives == {}


def test_counting_mode_counts_local_shards_and_collective_bytes():
    """On a fake (2, 2) world: a column- then row-parallel product is
    counted on each rank's shards (not the global product), and its one
    all-reduce over "model" by its result's bytes; an all-gather and an
    all-to-all over "data" by theirs."""
    from torch.distributed import _functional_collectives as funcol
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    B, D, F = 16, 32, 64
    with fake_world(4):
        mesh = make_mesh((2, 2), ("data", "model"))

        def put(shape, placements):
            return distribute_tensor(torch.empty(shape, device="meta"), mesh,
                                     placements)
        x = put((B, D), [Shard(0), Replicate()])
        w1 = put((D, F), [Replicate(), Shard(1)])
        w2 = put((F, D), [Replicate(), Shard(0)])

        def step():
            y = ((x @ w1) @ w2).redistribute(mesh, [Shard(0), Replicate()])
            g = mesh.get_group("data")
            loc = torch.empty(6, 5, device="meta")
            gathered = funcol.all_gather_single(loc, 0, g)
            swapped = funcol.all_to_all_single(loc, None, None, g)
            return y, gathered, swapped
        (y, gathered, swapped), t = op_analysis.count(step, mesh=mesh)
    assert not dist.is_initialized()
    assert t.flops == 2 * (B // 2) * D * (F // 2) * 2
    assert t.by_axis["model"] == {
        "all-reduce": {"count": 1.0, "bytes": 4.0 * (B // 2) * D}}
    assert t.by_axis["data"] == {
        "all-gather": {"count": 1.0, "bytes": 4.0 * 12 * 5},
        "all-to-all": {"count": 1.0, "bytes": 4.0 * 6 * 5}}
    assert t.collective_bytes == 4.0 * ((B // 2) * D + 12 * 5 + 6 * 5)


def test_kernel_custom_ops_are_counted_with_their_bound_formulas():
    from repro_torch.kernels import cost
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.ssd_scan import ops as ss_ops
    q = torch.empty(2, 4, 64, 32, device="meta", dtype=torch.bfloat16)
    k = torch.empty(2, 2, 64, 32, device="meta", dtype=torch.bfloat16)
    out, t = op_analysis.count(fa_ops.attention, q, k, k, causal=True,
                               window=16)
    assert out.shape == q.shape and out.device.type == "meta"
    assert (t.flops, t.kernel_calls) == (cost.flash_attention_cost(
        2, 4, 2, 64, 64, 32, True, 16, 2)[0], {"flash_attention": 1})
    assert cost.attention_pairs(64, 64, True, 16) == sum(
        min(i + 1, 16) for i in range(64))
    x = torch.empty(2, 64, 4, 16, device="meta")
    dt = torch.empty(2, 64, 4, device="meta")
    A = torch.empty(4, device="meta")
    Bm = torch.empty(2, 64, 8, device="meta")
    (y, st), t = op_analysis.count(ss_ops.ssd, x, dt, A, Bm, Bm, chunk=16)
    assert (y.shape, st.shape) == ((2, 64, 4, 16), (2, 4, 16, 8))
    assert t.flops == cost.ssd_scan_cost(2, 64, 4, 16, 8, 16, 4)[0]


def test_backward_kernel_op_is_counted_with_its_bound_formula():
    """The flash backward's custom op on meta tensors, called as
    ``KernelAttention.backward`` calls it: its fake gradients' shapes, and
    its FLOPs and bytes ``flash_attention_bwd_cost``'s (10·hd a kept pair;
    q, k, v, out, dout and lse read, dq, dk and dv written)."""
    from repro_torch.kernels import cost
    from repro_torch.kernels.flash_attention import ops as fa_ops
    q = torch.empty(2, 4, 64, 32, device="meta", dtype=torch.bfloat16)
    k = torch.empty(2, 2, 64, 32, device="meta", dtype=torch.bfloat16)
    out, lse = fa_ops.flash_attention_lse_op(q, k, k, True, 16, 0.0, None)
    grads, t = op_analysis.count(fa_ops.flash_attention_backward_op, q, k, k,
                                 out, lse, out, True, 16, 0.0, None)
    assert [g.shape for g in grads] == [q.shape, k.shape, k.shape]
    assert (t.flops, t.hbm_bytes, t.kernel_calls) == (
        *cost.flash_attention_bwd_cost(2, 4, 2, 64, 64, 32, True, 16, 2),
        {"flash_attention_backward": 1})
    assert t.flops == 2.5 * cost.flash_attention_cost(
        2, 4, 2, 64, 64, 32, True, 16, 2)[0]


# -- against the reference's hlo_analysis ---------------------------------------

#: a decode cell both packages run with the same dots: internlm2-1.8b cut
#: to 10 layers (1.01e9 parameters, so the rules shard it over "model"),
#: 4 sequences over a 64-slot cache, on a (2, 2) mesh
CUT = {"num_layers": 10}
TINY = ("decode_tiny", 64, 4, "decode")
REFERENCE = textwrap.dedent("""
    import os, sys, json
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax
    from repro.configs import SHAPES
    from repro.configs.base import ShapeSpec
    from repro.launch import dryrun
    name, seq, batch, kind = json.loads(sys.argv[1])
    SHAPES[name] = ShapeSpec(name, seq, batch, kind)
    dryrun.make_production_mesh = lambda multi_pod=False: jax.make_mesh(
        (2, 2), ("data", "model"))
    rec = dryrun.analyze_cell("internlm2-1.8b", name,
                              extra_cfg=json.loads(sys.argv[2]),
                              verbose=False)
    print(json.dumps({k: rec[k] for k in (
        "flops_per_device", "bytes_per_device",
        "collective_bytes_per_device", "collectives")}))
""")
#: the two packages' decode steps run the same products (the reference's
#: masked sdpa over the cache reads the same 64 keys the port's slices);
#: their sum agrees to the FLOP (float64 sums of exact integers)
FLOP_TOL = 1e-9


def test_decode_dot_flops_match_the_references_hlo_analysis(capsys):
    """The port splits every product of this cell four ways on the (2, 2)
    mesh (batch rows over "data", heads, d_ff and the vocabulary over
    "model"); XLA, on four host devices, gathers the weights (its
    all-gathers carry the whole model) and runs the step replicated, so
    its per-device FLOPs are the cell's global dots: they must equal four
    times the port's per-device count."""
    env = dict(os.environ, PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu")
    proc = subprocess.Popen(
        [sys.executable, "-c", REFERENCE, json.dumps(TINY), json.dumps(CUT)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    with fake_world(4):
        mesh = make_mesh((2, 2), ("data", "model"))
        got = dryrun.analyze_cell("internlm2-1.8b", ShapeSpec(*TINY),
                                  extra_cfg=CUT, mesh=mesh, verbose=False)
    out, err = proc.communicate(timeout=300)
    assert proc.returncode == 0, err
    want = json.loads(out.strip().splitlines()[-1])
    with capsys.disabled():
        print(f"\ndecode_tiny on 2x2: flops/device port "
              f"{got['flops_per_device']:.6e} reference "
              f"{want['flops_per_device']:.6e}; bytes/device port "
              f"{got['bytes_per_device']:.6e} reference "
              f"{want['bytes_per_device']:.6e}; collective bytes/device "
              f"port {got['collective_bytes_per_device']:.6e} reference "
              f"{want['collective_bytes_per_device']:.6e}")
    cfg = dataclasses.replace(get_config("internlm2-1.8b"), **CUT)
    assert cfg.param_count() > 1e9                   # sharded over "model"
    param_bytes = 2 * cfg.param_count()
    assert want["collectives"]["all-gather"]["bytes"] >= 0.99 * param_bytes
    # the port's step communicates only the row-parallel partial sums
    # (wo, w_out) and the vocab-parallel embedding's
    assert got["collective_ops"] == {"all_reduce": 2 * cfg.num_layers + 1}
    assert got["chips"] == 4
    assert abs(4 * got["flops_per_device"] / want["flops_per_device"] - 1) \
        <= FLOP_TOL


# -- the record and the entry point ---------------------------------------------

def test_cli_prints_a_record_with_the_references_keys():
    """The dry run's command line needs no card: it runs on the CPU and
    prints a record with the reference's keys."""
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "internlm2-1.8b", "--shape", "decode_32k"],
        env=dict(os.environ, PYTHONPATH=str(SRC)), capture_output=True,
        text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    text = out.stdout
    rec = json.loads(text[text.index("{"):])
    assert REFERENCE_KEYS <= set(rec) and "xla_cost_analysis_once" not in rec
    assert set(rec["memory_analysis"]) == {"argument_bytes", "output_bytes",
                                           "temp_bytes"}
    assert (rec["mesh"], rec["chips"], rec["kind"]) == ("32x8", 256,
                                                        "decode")
    assert rec["bottleneck"] in ("compute", "memory", "collective")
    assert rec["collective_s"] == pytest.approx(
        rec["collective_nvlink_s"] + rec["collective_network_s"])
    assert rec["flops_per_device"] > 0 and rec["compute_s"] > 0
    assert set(rec["collectives_by_axis"]) == {"model"}


def test_train_cell_runs_the_expert_exchange_and_restores_state():
    """llama4-maverick's train step at full width on the 256-rank fake
    world, cut to its first two layers (dense, then MoE): per microbatch
    the MoE layer's two all-to-alls over "model" run in the forward, again
    in the checkpointed recompute, and twice in the backward; the flash
    kernel runs through its custom op's fake forward (with the log-sum-exp
    the backward takes) and once more in each backward's recompute, and
    its backward kernel's op once a layer; the fake world, SPMD mode and
    the flash-decode flag are as they were after the call."""
    from repro_torch.pjit_utils import spmd_enabled
    cfg = dataclasses.replace(get_config("llama4-maverick-400b-a17b"),
                              num_layers=2)
    assert [s.ffn for s in cfg.all_specs] == ["dense", "moe"]
    rec = dryrun.analyze_cell("llama4-maverick-400b-a17b", "train_4k",
                              extra_cfg={"num_layers": 2},
                              variant={"flash_decode": True}, verbose=False)
    A = cfg.accum_steps
    assert rec["collective_ops"]["all_to_all_single"] == 6 * A
    assert rec["collectives_by_axis"]["model"]["all-to-all"]["count"] >= \
        6 * A
    assert "all-to-all" not in rec["collectives_by_axis"].get("data", {})
    assert rec["kernel_calls"] == {"flash_attention_lse": 2 * 2 * A,
                                   "flash_attention_backward": 2 * A}
    assert not dist.is_initialized() and not spmd_enabled()
    assert L.FLASH_DECODE_ENABLED is False


# -- flash decode ----------------------------------------------------------------

# (B, H, KV, hd, Skv, kv_len, window, softcap, block): a cache prefix, a
# window, a softcap, MQA, a cache that is not a multiple of the block, and
# a window that masks whole blocks
FD_CASES = [(2, 4, 2, 16, 100, 77, None, 0.0, 32),
            (2, 4, 1, 16, 128, 128, 40, 30.0, 32),
            (1, 4, 4, 16, 70, 5, None, 0.0, 32),
            (2, 4, 2, 16, 96, 90, 16, 0.0, 32),
            (1, 8, 2, 32, 300, 300, 64, 50.0, 64)]
FD_TOL = {"float32": 1e-5, "bfloat16": 2e-2}


@pytest.mark.parametrize("dname", sorted(FD_TOL))
@pytest.mark.parametrize("case", FD_CASES)
def test_flash_decode_matches_reference(case, dname):
    B, H, KV, hd, Skv, kv_len, window, cap, block = case
    rng = np.random.default_rng(Skv + kv_len)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((B, 1, H, hd), (B, Skv, KV, hd), (B, Skv, KV, hd)))
    jd, td = getattr(jnp, dname), getattr(torch, dname)
    kw = dict(kv_len=kv_len, window=window, attn_softcap=cap,
              q_offset=kv_len - 1, block=block)
    want = JL.flash_decode(*(jnp.asarray(a, jd) for a in (q, k, v)), **kw)
    got = L.flash_decode(*(torch.from_numpy(a).to(td) for a in (q, k, v)),
                         **kw)
    assert got.dtype == td and got.shape == (B, 1, H, hd)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=FD_TOL[dname], rtol=FD_TOL[dname])


@pytest.fixture
def flash_decode_on():
    was = (JL.FLASH_DECODE_ENABLED, L.FLASH_DECODE_ENABLED)
    JL.FLASH_DECODE_ENABLED = L.FLASH_DECODE_ENABLED = True
    yield
    JL.FLASH_DECODE_ENABLED, L.FLASH_DECODE_ENABLED = was


def test_decode_step_with_flash_decode_matches_reference(flash_decode_on):
    """A reduced internlm2-1.8b's prefill then two decode steps over a
    cache of the threshold's length, flash decode on in both packages."""
    cfg = jreduced(jget_config("internlm2-1.8b"))
    tcfg = reduced(get_config("internlm2-1.8b"))
    Lc = L.FLASH_DECODE_THRESHOLD
    assert Lc == JL.FLASH_DECODE_THRESHOLD
    params = JT.init_params(cfg, jax.random.PRNGKey(1))
    tparams = convert.params_from_jax(tcfg, jax.tree.map(np.asarray, params))
    rng = np.random.default_rng(1)
    prompt = rng.integers(0, cfg.vocab_size, (2, 8), dtype=np.int32)
    steps = rng.integers(0, cfg.vocab_size, (2, 2), dtype=np.int32)
    _, jcache = JT.prefill(cfg, params, jnp.asarray(prompt), cache_len=Lc)
    with torch.no_grad():
        _, tcache = TT.prefill(tcfg, tparams, torch.from_numpy(prompt),
                               cache_len=Lc)
    jstep = jax.jit(lambda p, c, t, pos: JT.decode_step(cfg, p, c, t, pos))
    for i in range(2):
        pos = 8 + i
        want, jcache = jstep(params, jcache, jnp.asarray(steps[:, i:i + 1]),
                             pos)
        with torch.no_grad():
            got, tcache = TT.decode_step(
                tcfg, tparams, tcache, torch.from_numpy(steps[:, i:i + 1]),
                pos)
            L.FLASH_DECODE_ENABLED = False
            plain, _ = TT.decode_step(
                tcfg, tparams, [dict(c, k=c["k"].clone(), v=c["v"].clone())
                                for c in tcache],
                torch.from_numpy(steps[:, i:i + 1]), pos)
            L.FLASH_DECODE_ENABLED = True
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=1e-4, rtol=1e-4)
        np.testing.assert_allclose(got.numpy(), plain.numpy(), atol=1e-4,
                                   rtol=1e-4)


# -- the "dots" remat policy -----------------------------------------------------

@pytest.mark.parametrize("arch", ["internlm2-1.8b", "mamba2-370m"])
def test_dots_remat_gradients_match_full_and_reference(arch):
    """Every gradient leaf under ``remat_policy="dots"`` equals that under
    "full" (the same values; only what is kept differs), and both match
    ``jax.grad`` of the reference's ``loss_fn`` with "dots" within
    ``tests/test_torch_train.py``'s limits."""
    GRAD_ABS, GRAD_REL_RMS = 1e-5, 1e-4
    jcfg = dataclasses.replace(jreduced(jget_config(arch)),
                               remat_policy="dots")
    params = JT.init_params(jcfg, jax.random.PRNGKey(2))
    rng = np.random.default_rng(2)
    tokens = rng.integers(0, jcfg.vocab_size, (4, 32), dtype=np.int32)
    batch = {"tokens": tokens, "labels": np.roll(tokens, -1, axis=1)}
    _, jgrads = jax.value_and_grad(
        lambda p: JT.loss_fn(jcfg, p, jax.tree.map(jnp.asarray, batch)),
        has_aux=True)(params)
    want = convert.state_from_jax(
        jcfg, {"params": jax.tree.map(np.asarray, jgrads)})["params"]
    tparams = convert.params_from_jax(jcfg, jax.tree.map(np.asarray, params))
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    grads = {}
    for policy in ("full", "dots"):
        cfg = dataclasses.replace(reduced(get_config(arch)),
                                  remat_policy=policy)
        assert cfg.remat
        _, _, grads[policy] = TS.value_and_grad(cfg, tparams, tbatch)
    for (path, g), d, w in zip(tree.flatten_with_paths(grads["full"]),
                               tree.leaves(grads["dots"]),
                               tree.leaves(want)):
        assert torch.equal(g, d), path
        w = w.numpy()
        for x in (g.numpy(), d.numpy()):
            np.testing.assert_allclose(x, w, rtol=0, atol=GRAD_ABS
                                       + GRAD_REL_RMS * np.abs(w).max(),
                                       err_msg=str(path))
            assert np.linalg.norm(x - w) <= GRAD_REL_RMS * max(
                np.linalg.norm(w), 1e-30), path


def test_dots_policy_keeps_the_products():
    """Under "dots" the backward recomputes no matmul of the layer: its
    forward runs each product once."""
    from torch.utils.checkpoint import CheckpointPolicy
    assert TT._save_dots(None, torch.ops.aten.mm.default) == \
        CheckpointPolicy.MUST_SAVE
    assert TT._save_dots(None, torch.ops.aten.add.Tensor) == \
        CheckpointPolicy.PREFER_RECOMPUTE
    cfg = dataclasses.replace(reduced(get_config("internlm2-1.8b")),
                              remat_policy="dots")
    params = TT.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    toks = torch.zeros((2, 16), dtype=torch.int32)
    counts = {}
    for policy in ("full", "dots"):
        c = dataclasses.replace(cfg, remat_policy=policy)
        with op_analysis.OpCounter() as counter:
            TS.value_and_grad(c, params, {"tokens": toks, "labels": toks})
        counts[policy] = counter.totals.flops
    assert counts["dots"] < counts["full"]
    with pytest.raises(ValueError, match="remat_policy"):
        TS.value_and_grad(dataclasses.replace(cfg, remat_policy="x"), params,
                          {"tokens": toks, "labels": toks})


def test_remat_policies_count_the_backward_kernel():
    """On meta tensors (the CUDA route's ops, as the dry run counts a train
    cell), under "full" and "dots" every layer runs the flash forward
    twice (with its log-sum-exp) and the backward kernel once, charged
    their formulas at the padded head dim (16 → 32), and "dots" still
    counts fewer FLOPs."""
    from repro_torch.kernels import cost
    cfg = reduced(get_config("internlm2-1.8b"))
    meta = TT.init_params(cfg, torch.Generator(), "meta")
    toks = torch.zeros((2, 16), dtype=torch.int32, device="meta")
    n, (B, S) = cfg.num_layers, toks.shape
    shape = (B, cfg.num_heads, cfg.num_kv_heads, S, S, 32, True, None)
    kernels = n * (2 * cost.flash_attention_cost(*shape, 4, lse=True)[0]
                   + cost.flash_attention_bwd_cost(*shape, 4)[0])
    counts = {}
    for policy in ("full", "dots"):
        c = dataclasses.replace(cfg, remat_policy=policy)
        with op_analysis.OpCounter() as counter:
            loss, _, _ = TS.value_and_grad(c, meta, {"tokens": toks,
                                                     "labels": toks})
        assert loss.device.type == "meta"
        assert counter.totals.kernel_calls == {
            "flash_attention_lse": 2 * n, "flash_attention_backward": n}
        counts[policy] = counter.totals.flops
        assert counter.totals.flops > kernels
    assert counts["dots"] < counts["full"]


# -- a cache split along its sequence, on two gloo ranks -------------------------

SPLIT_ARCHS = ("internlm2-1.8b", "recurrentgemma-9b")


def _seq_split_rank(rank, world, store_path, out_dir):
    """Batch-1 decode of reduced internlm2-1.8b and recurrentgemma-9b (its
    ring caches of 8 slots wrap in the prefill) on a (1, 2) mesh: the
    cache rules split each cache's sequence over both ranks, so the
    prefill writes each rank's block, every decode step writes one rank's,
    and attention combines the two blocks' softmax.  Rank 0 saves the
    logits and those of the one-device run fed the same tokens."""
    from torch.distributed.tensor import Shard, distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.launch import serve, shardings
    from repro_torch.pjit_utils import enable_spmd
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world)
    try:
        mesh = make_mesh((1, 2), ("data", "model"), "cpu")
        rep = shardings.to_placements(mesh, shardings.P(None, None))
        for arch in SPLIT_ARCHS:
            cfg = reduced(get_config(arch))
            params = TT.init_params(cfg, torch.Generator().manual_seed(0),
                                    "cpu")
            placed = shardings.distribute(mesh, params, shardings.param_pspecs(
                cfg, params, mesh))
            prompts = np.random.default_rng(4).integers(
                0, cfg.vocab_size, (1, 29), dtype=np.int32)
            enable_spmd(True)
            try:
                with torch.no_grad(), implicit_replication():
                    toks = distribute_tensor(torch.from_numpy(prompts), mesh,
                                             rep)
                    logits, cache = TT.prefill(cfg, placed, toks,
                                               cache_len=32)
                    split = [c["k"] for c in cache if "k" in c]
                    assert split and all(
                        k.placements == (Shard(1), Shard(1)) for k in split)
                    out = [logits.full_tensor()]
                    for i in range(3):
                        tok = torch.argmax(out[-1], -1)[:, None].to(
                            torch.int32)
                        lg, cache = TT.decode_step(
                            cfg, placed, cache,
                            distribute_tensor(tok, mesh, rep), 29 + i)
                        out.append(lg.full_tensor())
            finally:
                enable_spmd(False)
            with torch.no_grad():                 # the same tokens, one device
                lg, pc = TT.prefill(cfg, params, torch.from_numpy(prompts),
                                    cache_len=32)
                plain = [lg]
                for i in range(3):
                    tok = torch.argmax(out[i], -1)[:, None].to(torch.int32)
                    lg, pc = TT.decode_step(cfg, params, pc, tok, 29 + i)
                    plain.append(lg)
            want = serve.serve_batch(cfg, params, prompts, 4, device="cpu")[0]
            if rank == 0:
                np.savez(os.path.join(out_dir, f"{arch}.npz"),
                         logits=torch.stack(out).numpy(), want=want,
                         plain=torch.stack(plain).numpy())
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def split_runs(tmp_path_factory):
    import torch.multiprocessing as mp
    root = tmp_path_factory.mktemp("seq_split")
    mp.spawn(_seq_split_rank, args=(2, str(root / "store"), str(root)),
             nprocs=2, join=True)
    return {arch: np.load(root / f"{arch}.npz") for arch in SPLIT_ARCHS}


@pytest.mark.parametrize("arch", SPLIT_ARCHS)
def test_a_sequence_split_cache_decodes_as_one(split_runs, arch):
    """Decode over caches split along their sequence over two gloo ranks
    (each rank writes and attends its own block, the softmax combined
    across them; recurrentgemma's rings written slot by slot): logits
    within 1e-5 of the one-device run's on the same tokens (float32), and
    the greedy tokens ``serve_batch`` picks."""
    got = split_runs[arch]
    np.testing.assert_allclose(got["logits"], got["plain"], atol=1e-5,
                               rtol=1e-5)
    ids = got["logits"].argmax(-1)[:, 0]
    assert np.array_equal(ids, got["want"][0]), (ids, got["want"])
