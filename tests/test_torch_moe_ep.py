"""The torch port's expert-parallel MoE (``models/moe.moe_ffn_shard_map``)
on a 4-rank gloo world against the reference's ``moe_ffn_shard_map`` on a
4-device host mesh.

Both run a (2, 2) ("data", "model") mesh on the same seeded numpy weights
and tokens: the port in four processes (``torch.multiprocessing.spawn``,
a ``FileStore`` under ``tmp_path``, so no TCP port is shared between
xdist workers), the reference in a subprocess with
``--xla_force_host_platform_device_count=4``.  Two routes: a sequence
that "model" divides (tokens sequence-sharded, the shared expert
unsharded on each slice) and one it does not (tokens replicated over
"model", the shared expert d_ff-sliced with a sum over "model").  Outputs
and both aux terms are held within 1e-5 in float32.
"""

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

SRC = Path(__file__).resolve().parents[1] / "src"
E, K, D, F, CF = 8, 2, 32, 24, 1.25
# (B, S, capacity factor): S = 8 is divided by the 2 model ranks, S = 7 is
# not; a factor of E / K drops nothing
ROUTES = {"seq_sharded": (4, 8, CF), "replicated": (4, 7, CF),
          "no_drops": (4, 8, E / K)}
TOL = 1e-5


def _inputs(B, S, seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *s, sc=1.0: (rng.standard_normal(s) * sc).astype(np.float32)  # noqa: E731
    p = {"router": {"w": f(D, E, sc=D ** -0.5)},
         "w_in": f(E, D, F, sc=D ** -0.5), "w_gate": f(E, D, F, sc=D ** -0.5),
         "w_out": f(E, F, D, sc=F ** -0.5),
         "shared": {"w_in": {"w": f(D, F, sc=D ** -0.5)},
                    "w_gate": {"w": f(D, F, sc=D ** -0.5)},
                    "w_out": {"w": f(F, D, sc=F ** -0.5)}}}
    return p, f(B, S, D)


def _port_rank(rank, world, store_path, out_dir):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, distribute_tensor

    from repro_torch import tree as T
    from repro_torch.models import moe

    dist.init_process_group("gloo", store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world)
    try:
        mesh = init_device_mesh("cpu", (2, 2),
                                mesh_dim_names=("data", "model"))
        rep = [Replicate(), Replicate()]
        for name, (B, S, cf) in ROUTES.items():
            p, x = _inputs(B, S)
            dp = T.map(lambda a: distribute_tensor(torch.from_numpy(a), mesh,
                                                   rep), p)
            dx = distribute_tensor(torch.from_numpy(x), mesh, rep)
            y, aux = moe.moe_ffn_shard_map(dp, dx, num_experts=E, top_k=K,
                                           capacity_factor=cf,
                                           activation="silu")
            y = y.full_tensor()
            lb = aux["load_balance_loss"].full_tensor()
            dr = aux["dropped_frac"].full_tensor()
            if rank == 0:
                np.savez(os.path.join(out_dir, f"{name}.npz"), y=y.numpy(),
                         lb=lb.numpy(), dropped=dr.numpy())
    finally:
        dist.destroy_process_group()


REFERENCE = textwrap.dedent("""
    import os, sys, json
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax, numpy as np
    sys.path.insert(0, sys.argv[1])
    import test_torch_moe_ep as t
    from repro.models import moe
    mesh = jax.make_mesh((2, 2), ("data", "model"))
    set_mesh = getattr(jax, "set_mesh", None)
    ctx = set_mesh(mesh) if set_mesh is not None else mesh
    with ctx:
        for name, (B, S, cf) in t.ROUTES.items():
            p, x = t._inputs(B, S)
            fn = jax.jit(lambda p, x: moe.moe_ffn_shard_map(
                p, x, num_experts=t.E, top_k=t.K, capacity_factor=cf,
                activation="silu"))
            y, aux = fn(p, x)
            np.savez(os.path.join(sys.argv[2], name + ".npz"),
                     y=np.asarray(y), lb=np.asarray(aux["load_balance_loss"]),
                     dropped=np.asarray(aux["dropped_frac"]))
    print(json.dumps(sorted(t.ROUTES)))
""")


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    import torch.multiprocessing as mp
    root = tmp_path_factory.mktemp("moe_ep")
    port, ref = root / "port", root / "ref"
    port.mkdir()
    ref.mkdir()
    env = dict(os.environ, PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu")
    proc = subprocess.Popen(
        [sys.executable, "-c", REFERENCE, str(Path(__file__).parent),
         str(ref)], env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    # every process group lives and dies inside its spawned process
    mp.spawn(_port_rank, args=(4, str(root / "store"), str(port)), nprocs=4,
             join=True)
    out, err = proc.communicate(timeout=300)
    assert proc.returncode == 0, err
    assert json.loads(out.strip().splitlines()[-1]) == sorted(ROUTES)
    return {name: (np.load(port / f"{name}.npz"), np.load(ref / f"{name}.npz"))
            for name in ROUTES}


@pytest.mark.parametrize("route", sorted(ROUTES))
@pytest.mark.parametrize("what", ["y", "lb", "dropped"])
def test_expert_parallel_moe_matches_reference(results, route, what):
    got, want = results[route]
    assert got[what].shape == want[what].shape
    np.testing.assert_allclose(got[what], want[what], atol=TOL, rtol=TOL,
                               err_msg=f"{route} {what}")


def test_without_drops_the_exchange_changes_nothing(results):
    """With a capacity that drops nothing, the expert-parallel layer equals
    the port's single-device layer: the two all-to-alls move each token's
    rows to its experts and back without loss or reordering."""
    from repro_torch import tree as T
    from repro_torch.models import moe
    B, S, cf = ROUTES["no_drops"]
    p, x = _inputs(B, S)
    y, aux = moe.moe_ffn(T.map(torch.from_numpy, p), torch.from_numpy(x),
                         num_experts=E, top_k=K, capacity_factor=cf)
    got = results["no_drops"][0]
    assert float(got["dropped"]) == float(aux["dropped_frac"]) == 0.0
    np.testing.assert_allclose(got["y"], y.numpy(), atol=TOL, rtol=TOL)
