"""Production meshes on an H100 cluster, and the fake world the dry run
builds them on: the port of the JAX package's ``launch/mesh.py``.

The reference lays 256 chips out as a (16, 16) ("data", "model") pod and
two pods as (2, 16, 16) ("pod", "data", "model").  The port keeps the axis
names and the rank counts and lays them out as an H100 cluster is wired:
(32, 8) and (2, 32, 8), so that "model" (tensor and expert parallelism,
the chattiest axis) stays inside one 8-GPU NVLink node and every other
axis crosses the network.

A mesh is a ``torch.distributed`` ``DeviceMesh`` and needs a process
group.  With ``fake=True`` :func:`make_production_mesh` starts the fake
one (``torch.testing._internal.distributed.fake_pg``: every collective
returns at once, nothing is sent), so a 256- or 512-rank mesh exists in
one CPU process; :func:`fake_world` starts it for a ``with`` block and
destroys it after, unless one of the right size was already live.
Functions, so that importing this module starts nothing.
"""

from __future__ import annotations

import math
from contextlib import contextmanager
from typing import Dict, Sequence, Tuple

import torch.distributed as dist


class AbstractMesh:
    """Axis names and sizes with no devices and no process group: enough
    for the sharding rules (:mod:`.shardings`), as JAX's ``AbstractMesh``
    is for the reference's."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str]):
        self.axis_names = tuple(axis_names)
        self.axis_sizes = tuple(int(s) for s in shape)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))


def axis_names(mesh) -> Tuple[str, ...]:
    """The axis names of a ``DeviceMesh`` or an :class:`AbstractMesh`."""
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names) if names is not None else tuple(mesh.axis_names)


def axis_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of a ``DeviceMesh`` or an :class:`AbstractMesh`."""
    if isinstance(mesh, AbstractMesh):
        return mesh.shape
    return dict(zip(axis_names(mesh), mesh.shape))


def production_shape(multi_pod: bool) -> Tuple[Tuple[int, ...],
                                                Tuple[str, ...]]:
    """(shape, axis names): 32 × 8 = 256 GPUs; two of them, 512."""
    if multi_pod:
        return (2, 32, 8), ("pod", "data", "model")
    return (32, 8), ("data", "model")


def start_fake_world(size: int) -> bool:
    """Start a fake process group of ``size`` ranks (this process is rank
    0) unless one of that size is live; True when this call started it.
    A live group of another size or backend raises."""
    if dist.is_initialized():
        if dist.get_world_size() != size or dist.get_backend() != "fake":
            raise RuntimeError(
                f"a {dist.get_backend()} process group of "
                f"{dist.get_world_size()} ranks is live; the fake world "
                f"needs {size} ranks of its own")
        return False
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=size)
    return True


@contextmanager
def fake_world(size: int):
    """A fake process group of ``size`` ranks for the ``with`` block,
    destroyed after it unless it was live before."""
    started = start_fake_world(size)
    try:
        yield
    finally:
        if started:
            dist.destroy_process_group()


def make_mesh(shape: Sequence[int], names: Sequence[str],
              device_type: str = "cuda"):
    """A ``DeviceMesh`` over the live process group's ranks."""
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(names))


def make_production_mesh(multi_pod: bool = False, *, fake: bool = True):
    """The production ``DeviceMesh``: on a fake process group of 256 (512)
    ranks with ``fake=True`` (started here unless live; the caller
    destroys it, or runs this inside :func:`fake_world`), else on the live
    group, which must have that many ranks."""
    shape, names = production_shape(multi_pod)
    if fake:
        start_fake_world(math.prod(shape))
    return make_mesh(shape, names)


def data_axes(multi_pod: bool) -> Tuple[str, ...]:
    """Mesh axes the batch is sharded over."""
    return ("pod", "data") if multi_pod else ("data",)


def mesh_counts(mesh) -> Tuple[int, int]:
    """(dp_size, model_size) of a production mesh."""
    sizes = axis_sizes(mesh)
    model = sizes.get("model", 1)
    dp = sizes.get("data", 1) * sizes.get("pod", 1)
    return dp, model


# H100 hardware constants of the roofline (per GPU)
PEAK_FLOPS_BF16 = 989e12   # FLOP/s dense bf16: H100 SXM5 80GB data sheet, 700 W
HBM_BW = 3.35e12           # bytes/s HBM3: the same data sheet
NVLINK_BW = 450e9          # bytes/s a direction: NVLink 4 (900 GB/s both ways)
NETWORK_BW = 50e9          # bytes/s: one 400 Gb/s NIC a GPU, as in a DGX H100
#: the mesh axis whose collectives stay inside a node, on NVLink
NVLINK_AXES = ("model",)
