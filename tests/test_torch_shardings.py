"""The torch port's sharding rules (``launch/shardings.py``) against the JAX
package's (``launch/shardings.py``) on the reference's abstract meshes.

The reference's trees stack a pattern slot's layers (and an encoder's, and
the cross-attention caches) along a leading axis; the port keeps one
subtree per layer.  For every arch in ``list_archs()`` and on both the
(16, 16) and the (2, 16, 16) meshes, each port leaf's spec must equal the
reference's spec for its stacked leaf with that axis dropped — params
(FSDP-sharded at or above ``FSDP_THRESHOLD``), caches (with and without
``seq_shard_model``), batches and the train state's ZeRO-1 moments — every
leaf must be covered, and every sharded dimension must divide.  No
devices and no process group: both sides read only axis names and sizes.
"""

import functools

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from jax.sharding import AbstractMesh as JAbstractMesh  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402
from repro.configs import SHAPES as JSHAPES  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import list_archs  # noqa: E402
from repro.launch import shardings as JS  # noqa: E402
from repro.launch import specs as JSpecs  # noqa: E402
from repro.launch import steps as JSteps  # noqa: E402
from repro_torch import tree as T  # noqa: E402
from repro_torch.configs import SHAPES, get_config  # noqa: E402
from repro_torch.core.sharding_bridge import P  # noqa: E402
from repro_torch.launch import shardings as S  # noqa: E402
from repro_torch.launch import specs as Specs  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.launch.mesh import AbstractMesh  # noqa: E402
from repro_torch.models import transformer as TM  # noqa: E402
from repro_torch.models.convert import reference_path  # noqa: E402

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
ARCHS = list_archs()
# (B, L): decode_32k's batch and cache, and long_500k's batch-1 cache
CACHES = ((128, 32768), (1, 524288))


def _meshes(name):
    shape, names = MESHES[name]
    try:                                  # jax >= 0.5 signature
        jm = JAbstractMesh(shape, names)
    except TypeError:                     # jax 0.4.x: tuple of (name, size)
        jm = JAbstractMesh(tuple(zip(names, shape)))
    return jm, AbstractMesh(shape, names)


def _key(k):
    return str(getattr(k, "key", getattr(k, "idx", getattr(k, "name", k))))


def _ref_specs(spec_tree):
    """{path string: spec} of a reference spec tree."""
    flat, _ = jax.tree_util.tree_flatten_with_path(
        spec_tree, is_leaf=lambda x: isinstance(x, JP))
    return {"/".join(_key(k) for k in path): spec for path, spec in flat}


def _pad(spec, n):
    return list(spec) + [None] * (n - len(spec))


def _same(got, want, n):
    assert isinstance(got, P), got
    assert _pad(got, n) == _pad(want, n), (got, want)


@functools.lru_cache(maxsize=None)
def _params(arch):
    return (JSpecs.params_struct(jget_config(arch)),
            Specs.params_struct(get_config(arch)))


@functools.lru_cache(maxsize=None)
def _states(arch):
    jcfg, cfg = jget_config(arch), get_config(arch)
    return (JSpecs.state_struct(jcfg, JSteps.make_optimizer(jcfg)),
            Specs.state_struct(cfg, steps.make_optimizer(cfg)))


def _check_params(cfg, port_struct, port_specs, ref_specs):
    """Every port leaf against the reference's leaf (layer axis dropped);
    returns the number of leaves checked."""
    flat = T.flatten_with_paths(port_struct)
    specs = S.spec_leaves(port_specs)
    assert len(flat) == len(specs)
    for (path, leaf), spec in zip(flat, specs):
        ref, group = reference_path(cfg, path)
        want = list(ref_specs["/".join(map(str, ref))])
        if group is not None:
            assert want[:1] in ([], [None])
            want = want[1:]
        _same(spec, want, leaf.dim())
    return len(flat)


def _divides(struct, specs, mesh):
    sizes = mesh.shape
    for leaf, spec in zip(T.leaves(struct), S.spec_leaves(specs)):
        used = []
        for dim, e in zip(leaf.shape, _pad(spec, len(leaf.shape))):
            if e is None:
                continue
            axes = e if isinstance(e, tuple) else (e,)
            assert not set(axes) & set(used), spec
            used += list(axes)
            assert dim % int(np.prod([sizes[a] for a in axes])) == 0, \
                (tuple(leaf.shape), spec)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_match_reference(arch, mesh):
    jm, tm = _meshes(mesh)
    jcfg, cfg = jget_config(arch), get_config(arch)
    jstruct, struct = _params(arch)
    jspecs = JS.param_pspecs(jcfg, jstruct, jm)
    specs = S.param_pspecs(cfg, struct, tm)
    if cfg.param_count() >= S.FSDP_THRESHOLD:
        jspecs = JS.shard_over_dp(jspecs, jstruct, jm)
        specs = S.shard_over_dp(cfg, specs, struct, tm)
    n = _check_params(cfg, struct, specs, _ref_specs(jspecs))
    assert n == len(T.leaves(struct)) > 0
    _divides(struct, specs, tm)


def _cache_ref_path(cfg, path):
    """A port cache path → (the reference's path string, stacked?)."""
    if "cross" in path:
        return f"cross/{path[-1]}", True
    ref, group = reference_path(cfg, ("layers",) + tuple(path))
    return "/".join(map(str, ref)), group is not None


@pytest.mark.parametrize("seq_shard", [False, True])
@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_specs_match_reference(arch, mesh, seq_shard):
    jm, tm = _meshes(mesh)
    jcfg, cfg = jget_config(arch), get_config(arch)
    for B, L in CACHES:
        jstruct = JSpecs.cache_struct(jcfg, B, L)
        struct = TM.init_cache(cfg, B, L, zeros=TM.ShapeDtype)
        want = _ref_specs(JS.cache_pspecs(jcfg, jstruct, B, jm,
                                          seq_shard_model=seq_shard))
        specs = S.cache_pspecs(cfg, struct, B, tm, seq_shard_model=seq_shard)
        flat = T.flatten_with_paths(struct)
        got = S.spec_leaves(specs)
        assert len(flat) == len(got) > 0
        for (path, leaf), spec in zip(flat, got):
            ref, stacked = _cache_ref_path(cfg, path)
            w = list(want[ref])
            if stacked:
                assert w[:1] in ([], [None])
                w = w[1:]
            _same(spec, w, len(leaf.shape))
        _divides(struct, specs, tm)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_batch_specs_match_reference(arch, mesh):
    jm, tm = _meshes(mesh)
    jcfg, cfg = jget_config(arch), get_config(arch)
    for name in sorted(SHAPES):
        for B in (None, 1, 4):
            want = JS.batch_pspecs(jcfg, JSHAPES[name], jm, batch_override=B)
            got = S.batch_pspecs(cfg, SHAPES[name], tm, batch_override=B)
            assert sorted(got) == sorted(want)
            for k in want:
                _same(got[k], list(want[k]), 3)
            assert S.batch_axes_for(B or SHAPES[name].global_batch, cfg,
                                    tm) == JS.batch_axes_for(
                B or JSHAPES[name].global_batch, jcfg, jm)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_train_state_specs_match_reference(arch, mesh):
    """Params (FSDP at ≥50B) and the ZeRO-1 moments, which shard over the
    data axes too wherever the model is not small."""
    jm, tm = _meshes(mesh)
    jcfg, cfg = jget_config(arch), get_config(arch)
    jstate, state = _states(arch)
    jspecs = JS.train_state_pspecs(jcfg, jstate, jm)
    specs = S.train_state_pspecs(cfg, state, tm)
    assert specs["opt"].step == P()
    for what in ("params", "m", "v"):
        port = specs["params"] if what == "params" else \
            getattr(specs["opt"], what)
        ref = jspecs["params"] if what == "params" else \
            getattr(jspecs["opt"], what)
        n = _check_params(cfg, state["params"], port, _ref_specs(ref))
        assert n == len(T.leaves(state["params"]))
        _divides(state["params"], port, tm)


def test_to_placements_orders_shards_by_mesh_axis():
    from torch.distributed.tensor import Replicate, Shard
    mesh = AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    assert S.to_placements(mesh, P(("pod", "data"), None, "model")) == \
        [Shard(0), Shard(0), Shard(2)]
    assert S.to_placements(mesh, P()) == [Replicate()] * 3
    with pytest.raises(ValueError, match="order"):
        S.to_placements(mesh, P(("data", "pod")))
