"""Backend registry — capability-queried execution backends (DESIGN §9).

All ``backend=`` lookups go through one :class:`BackendRegistry`; an
unregistered name raises :class:`UnknownBackendError` listing what *is*
registered.

A :class:`Backend` is a frozen capability descriptor, not an executor:
the planner queries it to bind each partition node to a concrete op
(``device_rebucket`` vs ``host_argsort``), the store queries it to decide
whether columns live device-resident.  Third-party backends plug in via
``REGISTRY.register`` without touching planner or executor dispatch tables
— unknown capabilities simply bind to the host ops.

The torch device a device-resident backend runs on is chosen separately
(:func:`resolve_device`): CUDA by default, the CPU only when asked for.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, Tuple, Union

import torch

__all__ = ["Backend", "BackendRegistry", "UnknownBackendError", "REGISTRY",
           "resolve_backend", "backend_names", "resolve_device"]


class UnknownBackendError(KeyError, ValueError):
    """Raised for a ``backend=`` name that is not in the registry.

    Subclasses both ``KeyError`` (the historical dict-miss failure mode)
    and ``ValueError`` (the historical explicit-validation failure mode)
    so every pre-registry ``except`` clause keeps catching it.
    """

    def __init__(self, name: object, registered: Tuple[str, ...]):
        self.backend = name
        self.registered = tuple(registered)
        self.message = (
            f"unknown backend {name!r}; registered backends: "
            f"{', '.join(self.registered) or '(none)'}")
        super().__init__(self.message)

    def __str__(self) -> str:           # KeyError.__str__ would repr()-quote
        return self.message


def resolve_device(device: Union[str, torch.device]) -> torch.device:
    """``device`` as a :class:`torch.device`; a CUDA device with no card
    present raises instead of falling back to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' (or "
                "backend='host') to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}: use 'cuda' or 'cpu'")
    return dev


@dataclass(frozen=True)
class Backend:
    """Capability descriptor for one execution backend."""

    name: str
    #: columns of stored datasets live as torch tensors on the device
    device_resident: bool = False
    #: hash shuffles route through the cached ShufflePlan kernels (DESIGN §5)
    kernel_shuffle: bool = False
    #: scans relay flat device columns downstream (d2d chain, DESIGN §5)
    device_relay: bool = False
    #: reading a spilled dataset from a durable store promotes it
    #: host→device (DESIGN §10 eviction loop); host backends read straight
    #: through the lazy memmap views instead
    storage_prefetch: bool = False
    description: str = ""

    def partition_op(self, strategy: str, device: torch.device) -> str:
        """The concrete op a partition node binds to under this backend on
        ``device`` (the ShufflePlan mode follows the device: fused kernels
        on CUDA, hostperm on the CPU)."""
        if self.kernel_shuffle and strategy == "hash":
            from ..data.device_repartition import default_mode
            return f"device_rebucket[{default_mode(device)}]"
        if strategy == "range":
            return "host_range"
        return "host_argsort"


class BackendRegistry:
    """Name → :class:`Backend`, with clear errors for unknown names."""

    def __init__(self) -> None:
        self._backends: Dict[str, Backend] = {}

    def register(self, backend: Backend, *, overwrite: bool = False) -> Backend:
        if backend.name in self._backends and not overwrite:
            raise ValueError(f"backend {backend.name!r} already registered "
                             "(pass overwrite=True to replace)")
        self._backends[backend.name] = backend
        return backend

    def get(self, name) -> Backend:
        if isinstance(name, Backend):
            return name
        backend = self._backends.get(name)
        if backend is None:
            raise UnknownBackendError(name, self.names())
        return backend

    def names(self) -> Tuple[str, ...]:
        return tuple(self._backends)

    def __contains__(self, name: object) -> bool:
        return name in self._backends

    def __iter__(self) -> Iterator[Backend]:
        return iter(self._backends.values())

    def with_capability(self, **caps: bool) -> Tuple[Backend, ...]:
        """Backends whose descriptor matches every given capability flag,
        e.g. ``registry.with_capability(kernel_shuffle=True)``."""
        out = []
        for b in self._backends.values():
            if all(getattr(b, k) == v for k, v in caps.items()):
                out.append(b)
        return tuple(out)


#: The process-wide default registry, pre-seeded with the two built-ins.
REGISTRY = BackendRegistry()
REGISTRY.register(Backend(
    "host",
    description="numpy columnar execution; shuffles via stable argsort"))
REGISTRY.register(Backend(
    "device", device_resident=True, kernel_shuffle=True, device_relay=True,
    storage_prefetch=True,
    description="device-resident columns; hash shuffles via cached "
                "single-pass ShufflePlans (CUDA kernels on the card)"))


def resolve_backend(name, registry: BackendRegistry = None) -> Backend:
    """Resolve ``name`` (str or Backend) or raise :class:`UnknownBackendError`."""
    return (registry or REGISTRY).get(name)


def backend_names() -> Tuple[str, ...]:
    return REGISTRY.names()
