"""Meshes of ranks: counterpart of aimnetcentral_tpu/parallel/mesh.py and of
``parallel/spatial.py::make_spatial_mesh``.

JAX lays its devices out as a ``jax.sharding.Mesh`` inside one program.
The port runs one process (rank) per shard, started by ``torchrun`` or by
:func:`spawn` (``torch.multiprocessing`` with the ``spawn`` start method: a
process that has started CUDA cannot ``fork`` one that uses it), and a
:class:`Mesh` lays the ranks of a ``torch.distributed`` world out on named
axes: ``("sp",)`` or ``("sp", "spy")`` for spatial decomposition, with
``"ens"`` in front to give each ensemble member its own ring or torus
(``make_spatial_mesh(..., n_ens=2)``), and ``("dp", "ens")`` for data and
ensemble parallelism (:func:`make_mesh`, which the data-parallel train
step and trainer build on).  :meth:`Mesh.sub` is the slice of this rank
over some of the axes: the spatial collectives of one member run on its
``("sp", "spy")`` slice, never across members.

The backend follows the hardware (:func:`init_distributed`), and the
choice is logged:

- as many cards on a node as ranks on it: NCCL, one card a rank;
- fewer cards than the node's ranks: they share the cards and talk through gloo,
  with every buffer staged through the host (NCCL refuses two ranks on one
  device);
- on the CPU: gloo.

Nothing falls back silently: a failed initialisation raises.
"""

from __future__ import annotations

import dataclasses
import itertools
import logging
import os
from typing import Any, Callable

import numpy as np
import torch
import torch.distributed as dist

from aimnetcentral_tpu_torch.device import resolve_device
from aimnetcentral_tpu_torch.system import System

_log = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Ranks of the world laid out row-major over ``shape`` on named axes.

    ``coords`` are this rank's coordinates, ``group`` the process group of
    every rank of the mesh, ``slice_groups[axes]`` the group of the ranks
    that share this rank's coordinates on every axis but ``axes`` (its
    slice over ``axes``, for each nonempty proper subset of the axes in
    axis order; over one axis, its line).  ``stage`` is True when
    collectives on ``device`` tensors go through host buffers (gloo on a
    card)."""

    axis_names: tuple[str, ...]
    shape: tuple[int, ...]
    ranks: tuple[int, ...]  # global ranks, row-major over ``shape``
    coords: tuple[int, ...]
    group: Any
    slice_groups: dict[tuple[str, ...], Any]
    device: torch.device
    backend: str

    @property
    def size(self) -> int:
        return len(self.ranks)

    @property
    def index(self) -> int:
        """This rank's row-major position in the mesh."""
        return int(np.ravel_multi_index(self.coords, self.shape))

    @property
    def lead(self) -> bool:
        """Whether this rank is the mesh's first (on a :meth:`sub` mesh, the
        first of its slice): the one that adds the terms every rank computes
        alike (a replicated energy) to its share, and that writes files."""
        return all(c == 0 for c in self.coords)

    def sub(self, axes: tuple[str, ...]) -> "Mesh":
        """This rank's slice over ``axes`` as a mesh of its own: the ranks
        that share this rank's coordinates on the other axes, laid out over
        ``axes`` (in the mesh's axis order), with that slice's group."""
        if not axes or not set(axes) <= set(self.axis_names):
            raise ValueError(f"axes {axes} are not all axes of the mesh {self.axis_names}")
        axes = tuple(a for a in self.axis_names if a in axes)
        if axes == self.axis_names:
            return self
        keep = [self.axis_names.index(a) for a in axes]
        shape = tuple(self.shape[i] for i in keep)
        ranks = []
        for flat in range(int(np.prod(shape))):
            c = list(self.coords)
            for i, ci in zip(keep, np.unravel_index(flat, shape)):
                c[i] = int(ci)
            ranks.append(self.rank_at(tuple(c)))
        slices = {k: g for k, g in self.slice_groups.items() if set(k) < set(axes)}
        return dataclasses.replace(self, axis_names=axes, shape=shape, ranks=tuple(ranks),
                                   coords=tuple(self.coords[i] for i in keep), group=self.slice_groups[axes],
                                   slice_groups=slices)

    @property
    def stage(self) -> bool:
        return self.backend == "gloo" and self.device.type == "cuda"

    def rank_at(self, coords: tuple[int, ...]) -> int:
        """The global rank at ``coords`` (each taken modulo its axis)."""
        flat = 0
        for c, n in zip(coords, self.shape):
            flat = flat * n + c % n
        return self.ranks[flat]


def init_distributed(
    rank: int | None = None,
    world_size: int | None = None,
    init_method: str | None = None,
    device: str | torch.device = "cuda",
) -> torch.device:
    """Join the default process group, choosing the backend from the
    hardware, and return this rank's device.

    ``rank``, ``world_size`` and ``init_method`` default to torchrun's
    environment (``RANK``, ``WORLD_SIZE``, ``env://``), and then this
    node's ranks are ``LOCAL_RANK`` of ``LOCAL_WORLD_SIZE``; a rank given
    explicitly is taken as a rank of one node.  On the card
    (:func:`card_backend`): NCCL with ``cuda:<local rank>`` when the node
    has at least as many cards as ranks, else gloo on ``cuda:<local rank
    mod cards>`` (ranks share cards, and collectives stage through the
    host).  ``device="cpu"``: gloo."""
    from_env = rank is None
    rank = int(os.environ["RANK"]) if rank is None else rank
    world_size = int(os.environ["WORLD_SIZE"]) if world_size is None else world_size
    init_method = init_method or "env://"
    if from_env:
        local = int(os.environ.get("LOCAL_RANK", rank))
        local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world_size))
    else:
        local, local_world = rank, world_size
    dev = resolve_device(device)
    if dev.type == "cuda":
        backend, index = card_backend(torch.cuda.device_count(), local, local_world)
        dev = torch.device("cuda", index)
        torch.cuda.set_device(dev)
    else:
        backend = "gloo"
    kwargs = {"device_id": dev} if backend == "nccl" else {}
    dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world_size, **kwargs)
    _log.info("distributed: backend %s, world size %d, rank %d (local %d of %d) on %s",
              backend, world_size, rank, local, local_world, dev)
    return dev


def card_backend(n_cards: int, local_rank: int, local_world: int) -> tuple[str, int]:
    """The backend and the card index of local rank ``local_rank`` of the
    ``local_world`` ranks on a node with ``n_cards`` cards: NCCL, a card a
    rank, when the cards suffice (NCCL refuses two ranks on one card), else
    gloo with the ranks sharing the cards round robin."""
    if n_cards < 1:
        raise RuntimeError("no CUDA card on this node")
    if n_cards >= local_world:
        return "nccl", local_rank
    return "gloo", local_rank % n_cards


def _slices(shape: tuple[int, ...], axes: tuple[int, ...]) -> list[list[int]]:
    """Every slice of the row-major grid ``shape`` over ``axes`` (the points
    that differ only there), as flat indices row-major over ``axes``, in one
    order every rank computes alike."""
    idx = np.arange(int(np.prod(shape))).reshape(shape)
    rest = [a for a in range(len(shape)) if a not in axes]
    lines = np.transpose(idx, rest + list(axes)).reshape(-1, int(np.prod([shape[a] for a in axes])))
    return [list(map(int, row)) for row in lines]


def _proper_subsets(n: int) -> list[tuple[int, ...]]:
    """The nonempty proper subsets of ``range(n)``, each in axis order, by
    size then lexicographically."""
    return [c for k in range(1, n) for c in itertools.combinations(range(n), k)]


def _default_device(device: torch.device | None) -> torch.device:
    """``device``, else the card init_distributed chose, else the CPU."""
    if device is None:
        device = torch.device("cuda", torch.cuda.current_device()) if torch.cuda.is_available() else "cpu"
    return torch.device(device)


def world_mesh(device: torch.device | None = None) -> Mesh:
    """The default world as a one-axis mesh (``("world",)``) on its default
    group: no group is created, so one rank may build it alone."""
    if not dist.is_initialized():
        raise RuntimeError("call init_distributed (or torch.distributed.init_process_group) first")
    n = dist.get_world_size()
    return Mesh(axis_names=("world",), shape=(n,), ranks=tuple(range(n)), coords=(dist.get_rank(),),
                group=dist.group.WORLD, slice_groups={}, device=_default_device(device),
                backend=dist.get_backend())


def _make(axis_names: tuple[str, ...], shape: tuple[int, ...], device: torch.device | None) -> Mesh | None:
    """The mesh over the world's first prod(shape) ranks.  Every rank of the
    world must call it (group creation is collective); ranks outside the
    mesh get None."""
    if not dist.is_initialized():
        raise RuntimeError("call init_distributed (or torch.distributed.init_process_group) first")
    n = int(np.prod(shape))
    world = dist.get_world_size()
    if n > world:
        raise ValueError(f"a mesh of {shape} needs {n} ranks; the world has {world}")
    backend = dist.get_backend()
    ranks = list(range(n))
    group = dist.new_group(ranks)
    me = dist.get_rank()
    slice_groups: dict[tuple[str, ...], Any] = {}
    for axes in _proper_subsets(len(shape)):
        for members in _slices(tuple(shape), axes):
            g = dist.new_group([ranks[i] for i in members])
            if me in members:
                slice_groups[tuple(axis_names[a] for a in axes)] = g
    if me >= n:
        return None
    coords = tuple(int(c) for c in np.unravel_index(me, shape))
    return Mesh(axis_names=axis_names, shape=tuple(shape), ranks=tuple(ranks), coords=coords, group=group,
                slice_groups=slice_groups, device=_default_device(device), backend=backend)


def make_spatial_mesh(n_sp: int, n_spy: int = 1, device: torch.device | None = None,
                      n_ens: int = 1) -> Mesh | None:
    """A ring over x-slabs, or (``n_spy > 1``) a 2-D torus over (x, y)
    column tiles: axis names ``("sp",)`` / ``("sp", "spy")``, the world's
    first ``n_sp * n_spy`` ranks (x-major, as JAX's device array).  With
    ``n_ens > 1`` an ``"ens"`` axis goes in front, ens-major (JAX's
    ``devices.reshape(n_ens, n_sp[, n_spy])``): each member's ring or torus
    is one slice of ``n_sp * n_spy`` ranks.  Every rank of the world calls
    it; those beyond the mesh get None."""
    names, shape = ("sp",), (n_sp,)
    if n_spy > 1:
        names, shape = ("sp", "spy"), (n_sp, n_spy)
    if n_ens > 1:
        names, shape = ("ens",) + names, (n_ens,) + shape
    return _make(names, shape, device)


def make_mesh(n_dp: int | None = None, n_ens: int = 1, device: torch.device | None = None) -> Mesh | None:
    """A ``("dp", "ens")`` mesh: data parallelism over ``dp`` (by default
    every rank the ensemble axis leaves), ensemble members over ``ens``."""
    world = dist.get_world_size() if dist.is_initialized() else 0
    n_dp = n_dp or (world // n_ens)
    return _make(("dp", "ens"), (n_dp, n_ens), device)


def _broadcast(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    buf = t.detach().to(mesh.device).contiguous()
    host = buf.cpu() if mesh.stage else buf
    dist.broadcast(host, src=mesh.ranks[0], group=mesh.group)
    return host.to(mesh.device)


def replicate(mesh: Mesh, tree: Any) -> Any:
    """The first rank's copy of a tree of tensors (parameters) on every
    rank of the mesh, on its device."""
    if isinstance(tree, dict):
        return {k: replicate(mesh, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(replicate(mesh, v) for v in tree)
    return _broadcast(tree, mesh)


@dataclasses.dataclass(frozen=True)
class BatchSharding:
    """Leading-axis data-parallel sharding: this rank's block ``index`` of
    ``count`` equal contiguous blocks (JAX's ``NamedSharding(mesh,
    P("dp"))``)."""

    index: int
    count: int

    def take(self, x: torch.Tensor) -> torch.Tensor:
        if x.shape[0] % self.count:
            raise ValueError(f"a leading axis of {x.shape[0]} does not split into {self.count} blocks")
        n = x.shape[0] // self.count
        return x[self.index * n : (self.index + 1) * n]


def batch_sharding(mesh: Mesh) -> BatchSharding:
    return BatchSharding(index=mesh.coords[mesh.axis_names.index("dp")],
                         count=mesh.shape[mesh.axis_names.index("dp")])


def shard_system(mesh: Mesh, batch: System) -> System:
    """This rank's block of a stacked System batch (leading axis =
    microbatch, ``builders.stack_systems``) over the ``dp`` axis, on its
    device."""
    sharding = batch_sharding(mesh)
    fields = {
        f.name: sharding.take(getattr(batch, f.name)).to(mesh.device)
        for f in dataclasses.fields(batch)
        if isinstance(getattr(batch, f.name), torch.Tensor)
    }
    return batch.replace(**fields)


def _spawned(rank: int, fn: Callable, world_size: int, init_method: str, device: str, args: tuple) -> None:
    dev = init_distributed(rank, world_size, init_method, device)
    try:
        fn(rank, dev, *args)
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable, world_size: int, args: tuple = (), device: str = "cuda", port: int | None = None) -> None:
    """Run ``fn(rank, device, *args)`` on ``world_size`` new processes (the
    ``spawn`` start method), each a rank of one world on ``localhost``;
    joins them and raises if any failed.  ``fn`` must be importable by
    name (it is pickled)."""
    import socket

    import torch.multiprocessing as mp

    if port is None:
        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
    mp.start_processes(_spawned, args=(fn, world_size, f"tcp://localhost:{port}", device, args),
                       nprocs=world_size, join=True, start_method="spawn")
