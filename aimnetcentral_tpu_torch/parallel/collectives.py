"""Collectives that autograd differentiates, for a model sharded over ranks.

JAX differentiates through ``ppermute`` and ``psum`` by transposing them.
These ``torch.autograd.Function``s are their counterparts on a
``torch.distributed`` mesh (parallel/mesh.py):

- :func:`halo_exchange` extends a rank's block along one mesh axis with
  ``h`` rows of each ring neighbour's block (a ring shift each way).  Its
  backward is the opposite shift: the cotangents of the halo rows go home
  and are added into the owner's boundary rows.
- :func:`all_reduce_sum` sums a tensor over the mesh.  Its backward is an
  all-reduce of the cotangents: each rank's part of the sum reaches every
  rank's energy, through what each rank does with the sum.
- :func:`sum_replicated` sums over the mesh a quantity that the caller then
  holds as ONE value, the same on every rank (the total energy).  Every
  rank differentiates its own share: the backward hands each rank's
  cotangent to its own term unchanged.  An all-reduce backward there
  (``torch.distributed.nn.functional.all_reduce``'s) would count every
  force ``world_size`` times.

The model built on these differentiates each rank's own core energy, and
the all-reduces inside it carry the cross-rank terms.  Every rank must run
the same collectives in the same order, forward and backward: a term that
only one rank adds (a replicated energy) is still built on every rank and
weighted by 0 elsewhere, so that every rank's backward reaches the same
collectives.

Point-to-point pairs are posted together (``batch_isend_irecv``) and
matched by order (NCCL) or by tag (gloo).  With gloo on a card the buffers
go through the host (``Mesh.stage``).

:data:`clock` adds up the host seconds of the halo exchanges' swaps and of
the all-reduces, each call between two synchronisations of its device; it
is off unless ``clock.on`` is set, as the kernels' launch counters are
read by whoever resets them.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from collections.abc import Iterator

import torch
import torch.distributed as dist

from aimnetcentral_tpu_torch.parallel.mesh import Mesh


@dataclasses.dataclass(frozen=True)
class Ring:
    """This rank's ring along one mesh axis: its coordinate ``index`` of
    ``n`` and the global ranks of its neighbours at ``index - 1`` (``prev``)
    and ``index + 1`` (``next``)."""

    index: int
    n: int
    prev: int
    next: int


def ring(mesh: Mesh, axis: str) -> Ring:
    a = mesh.axis_names.index(axis)
    coords = list(mesh.coords)

    def at(d: int) -> int:
        c = list(coords)
        c[a] += d
        return mesh.rank_at(tuple(c))

    return Ring(index=coords[a], n=mesh.shape[a], prev=at(-1), next=at(1))


@dataclasses.dataclass
class Clock:
    """Host seconds in the collectives while ``on``: ``exchange`` (the halo
    exchanges' point-to-point swaps, forward and backward) and
    ``all_reduce`` (every all-reduce)."""

    on: bool = False
    exchange: float = 0.0
    all_reduce: float = 0.0

    def reset(self) -> None:
        self.exchange = self.all_reduce = 0.0

    @contextlib.contextmanager
    def timing(self, key: str, device: torch.device) -> Iterator[None]:
        if not self.on:
            yield
            return
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            setattr(self, key, getattr(self, key) + time.perf_counter() - t0)


clock = Clock()


def _swap(mesh: Mesh, r: Ring, to_next: torch.Tensor, to_prev: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Send ``to_next`` to the next rank and ``to_prev`` to the previous one;
    return ``(from_prev, from_next)``: what the previous rank sent to its
    next, and what the next rank sent to its previous."""
    if r.n == 1:
        return to_next, to_prev
    dev = to_next.device
    with clock.timing("exchange", dev):
        sends = [t.contiguous() for t in (to_next, to_prev)]
        if mesh.stage:
            sends = [t.cpu() for t in sends]
        recvs = [torch.empty_like(sends[0]), torch.empty_like(sends[1])]
        ops = [
            dist.P2POp(dist.isend, sends[0], r.next, mesh.group, tag=0),
            dist.P2POp(dist.irecv, recvs[0], r.prev, mesh.group, tag=0),
            dist.P2POp(dist.isend, sends[1], r.prev, mesh.group, tag=1),
            dist.P2POp(dist.irecv, recvs[1], r.next, mesh.group, tag=1),
        ]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return recvs[0].to(dev), recvs[1].to(dev)


class _HaloExchange(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, r, dim, h):
        ctx.mesh, ctx.r, ctx.dim, ctx.h = mesh, r, dim, h
        n = x.shape[dim]
        left, right = _swap(mesh, r, x.narrow(dim, n - h, h), x.narrow(dim, 0, h))
        return torch.cat([left, x, right], dim=dim)

    @staticmethod
    def backward(ctx, g):
        mesh, r, dim, h = ctx.mesh, ctx.r, ctx.dim, ctx.h
        n = g.shape[dim] - 2 * h
        g_left, g_core, g_right = g.narrow(dim, 0, h), g.narrow(dim, h, n), g.narrow(dim, h + n, h)
        # the previous rank's next halo is my first rows; the next rank's
        # previous halo is my last rows
        from_prev, from_next = _swap(mesh, r, g_right, g_left)
        g_core = g_core.clone()
        g_core.narrow(dim, 0, h).add_(from_prev)
        g_core.narrow(dim, n - h, h).add_(from_next)
        return g_core, None, None, None, None


def halo_exchange(x: torch.Tensor, mesh: Mesh, axis: str, dim: int, h: int) -> torch.Tensor:
    """``x`` extended along ``dim`` by the last ``h`` rows of the previous
    rank's block (before) and the first ``h`` of the next rank's (after),
    along the ring of mesh axis ``axis``.  Every rank of the mesh calls it
    with the same shapes.  Integer tensors pass too (not differentiated)."""
    return _HaloExchange.apply(x, mesh, ring(mesh, axis), dim, h)


def _all_reduce(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    with clock.timing("all_reduce", x.device):
        buf = x.detach().clone().contiguous()
        if mesh.stage:
            host = buf.cpu()
            dist.all_reduce(host, group=mesh.group)
            return host.to(x.device)
        dist.all_reduce(buf, group=mesh.group)
        return buf


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return _all_reduce(x, mesh)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.mesh), None


def all_reduce_sum(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``mesh``; the backward sums the
    cotangents over the ranks too."""
    return _AllReduceSum.apply(x, mesh)


class _SumReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        return _all_reduce(x, mesh)

    @staticmethod
    def backward(ctx, g):
        return g, None


def sum_replicated(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The sum of every rank's share ``x``, held as one replicated value:
    differentiating it on every rank (with the same cotangent) gives each
    rank the gradient of the whole sum with respect to its own inputs."""
    return _SumReplicated.apply(x, mesh)


def all_gather(x: torch.Tensor, mesh: Mesh) -> list[torch.Tensor]:
    """Every rank's ``x`` (same shape on all), in mesh rank order; not
    differentiated."""
    src = x.detach().contiguous()
    if mesh.stage:
        src = src.cpu()
    out = [torch.empty_like(src) for _ in range(mesh.size)]
    dist.all_gather(out, src, group=mesh.group)
    return [t.to(x.device) for t in out]
