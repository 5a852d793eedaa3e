"""Forces, stress, dense Hessians and Hessian-vector products by autograd
(counterpart of aimnetcentral_tpu/calculators/derivatives.py).

Forces are ``-dE/dcoord``; stress is the gradient with respect to a
per-molecule row-vector strain over the cell volume.  Second derivatives
are double backward: an HVP is the gradient of ``<dE/dcoord, v>``, and the
dense Hessian stacks those for the unit vectors of the real atoms' rows,
batched in chunks (JAX takes ``jacfwd`` of the gradient).  On the indexed
layout every op is plain torch and twice differentiable; on the binned
layouts the conv and pair kernels' wrappers carry the K3 second-order rules
(kernels/conv_pass.py::ConvAcc, kernels/pair_sweep.py::PairAcc).  The
calculator sends Hessians and HVPs to the indexed layout, as JAX does.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Iterator

import torch

from aimnetcentral_tpu_torch.models.aimnet2 import AIMNet2Config, aimnet2_apply
from aimnetcentral_tpu_torch.ops.math import cellmul
from aimnetcentral_tpu_torch.system import System

HESSIAN_MEMORY_SHARE = 0.25  # of the card's memory a dense Hessian's chunk of rows may take
HESSIAN_ROW_COPIES = 4  # a batched row's memory over the first-order graph's (a margin; PERF.md)
CPU_HESSIAN_CHUNK = 64  # rows a chunk on the CPU


def apply_strain(system: System, scaling: torch.Tensor) -> System:
    """coord' = coord @ S[mol], cell' = cell @ S.  ``scaling`` is
    (num_mol, 3, 3); padding atoms read the identity."""
    eye = torch.eye(3, dtype=scaling.dtype, device=scaling.device)[None]
    atom_scaling = torch.cat([scaling, eye], dim=0)[system.mol_idx]  # (N, 3, 3)
    coord = cellmul(system.coord[:, None, :], atom_scaling)[:, 0]  # exact f32 at every tier
    cell = cellmul(system.cell, scaling) if system.cell is not None else None
    return system.replace(coord=coord, cell=cell)


_KEEP = ("charges", "spin_charges", "mol_element_counts", "dipole", "quadrupole")


def hessian_chunk(system: System, rows: int, graph_bytes: int) -> int:
    """Unit rows a batched double backward takes at once.  On the card:
    ``HESSIAN_MEMORY_SHARE`` of its memory over ``HESSIAN_ROW_COPIES``
    times the bytes that the first-order graph holds (``graph_bytes``, the
    tensors the forward and the differentiable gradient save,
    ``saved_tensor_bytes``); an all-pairs indexed molecule's ``a[nbmat]``
    alone is (N, M, 16, 16) f32 per row.  Every input of it is fixed by the
    request's shapes: another chunk batches the rows' products otherwise
    and adds them in another order, so a chunk that moved with the
    allocator's state (its free memory, or the growth of its allocated
    memory, which a process's first products inflate by cuBLAS's
    workspace) would not give one input the same bits twice.  On the CPU
    ``CPU_HESSIAN_CHUNK``.  Binned layouts take
    one row at a time: the second backward runs the kernels' wrappers
    again (B and E as first adjoints), and they take no vmap-batched
    tensors."""
    if system.bins is not None:
        return 1
    if system.device.type != "cuda":
        return min(rows, CPU_HESSIAN_CHUNK)
    total = torch.cuda.get_device_properties(system.device).total_memory
    per_row = HESSIAN_ROW_COPIES * max(graph_bytes, 1)
    return max(1, min(rows, int(HESSIAN_MEMORY_SHARE * total) // per_row))


class SavedTensorBytes:
    """The bytes of the distinct storages that autograd saves while it is
    entered (``saved_tensors_hooks``): what a graph holds, a function of
    the shapes alone."""

    def __init__(self) -> None:
        self._storages: dict[int, int] = {}

    def _pack(self, t: torch.Tensor) -> torch.Tensor:
        st = t.untyped_storage()
        self._storages[st.data_ptr()] = st.nbytes()
        return t

    @property
    def total(self) -> int:
        return sum(self._storages.values())

    @contextlib.contextmanager
    def counting(self) -> Iterator["SavedTensorBytes"]:
        with torch.autograd.graph.saved_tensors_hooks(self._pack, lambda t: t):
            yield self


def dense_hessian(grad: torch.Tensor, coord: torch.Tensor, real: torch.Tensor, chunk: int) -> torch.Tensor:
    """(N, 3, N, 3) Jacobian of ``grad`` (N, 3), a differentiable gradient
    of ``coord``, over the rows of the real atoms (``real``, (N,) bool); the
    padding atoms' rows and columns are zero (no energy reads a padding
    coordinate).  The unit rows go through the double backward ``chunk`` at
    a time (``is_grads_batched`` when ``chunk`` > 1)."""
    n = coord.shape[0]
    flat = (torch.nonzero(real)[:, :1] * 3 + torch.arange(3, device=coord.device)).reshape(-1)
    rows = flat.shape[0]
    units = torch.zeros((rows, 3 * n), dtype=coord.dtype, device=coord.device)
    units[torch.arange(rows, device=coord.device), flat] = 1.0
    units = units.reshape(rows, n, 3)
    h = torch.zeros((rows, n, 3), dtype=coord.dtype, device=coord.device)
    for lo in range(0, rows, chunk):
        hi = min(rows, lo + chunk)
        if chunk > 1:
            (h[lo:hi],) = torch.autograd.grad(grad, coord, units[lo:hi], retain_graph=True, is_grads_batched=True)
        else:
            (h[lo],) = torch.autograd.grad(grad, coord, units[lo], retain_graph=True)
    out = torch.zeros((3 * n, n, 3), dtype=coord.dtype, device=coord.device)
    out[flat] = h
    return out.reshape(n, 3, n, 3)


def make_eval_fn(
    cfg: AIMNet2Config,
    *,
    forces: bool = False,
    stress: bool = False,
    hessian: bool = False,
    sae_external: bool = True,
    matmul_precision: str | None = None,
    conv_precision: str | None = None,
) -> Callable[[dict, System], dict]:
    """``f(params, system) -> outputs``: ``energy`` (num_mol,), plus
    ``forces`` (N, 3), ``stress`` (num_mol, 3, 3) and ``hessian`` (N, 3,
    N, 3) as requested, and ``charges`` (and ``mol_element_counts`` under
    SAE externalization, the dipole and quadrupole of models with those
    heads).  As in JAX, a Hessian request without stress also returns the
    forces.

    ``matmul_precision`` ("highest" or "default", a tier's first half,
    calculators/calculator.py::precision_tiers) wraps the forward and the
    gradient in ``ambient_matmul_context``; ``None`` keeps the caller's
    ambient.  ``conv_precision`` is kernels A and B's mode
    (``aimnet2_apply``)."""

    def collect(data: dict) -> dict:
        out = {"energy": data["energy"].detach()}
        for k in _KEEP:
            if data.get(k) is not None:
                out[k] = data[k].detach()
        return out

    def eval_fn(params: dict, system: System) -> dict:
        with _ambient(matmul_precision):
            return eval_inner(params, system)

    def eval_inner(params: dict, system: System) -> dict:
        if not (forces or stress or hessian):
            with torch.no_grad():
                return collect(aimnet2_apply(params, cfg, system, sae_external=sae_external,
                                             conv_precision=conv_precision))
        coord = system.coord.detach().requires_grad_(True)
        inputs = [coord]
        sys2 = system.replace(coord=coord)
        if stress:
            if system.cell is None:
                raise ValueError("stress requires a periodic cell")
            scaling = (
                torch.eye(3, dtype=coord.dtype, device=coord.device)
                .expand(system.num_mol, 3, 3)
                .clone()
                .requires_grad_(True)
            )
            inputs.append(scaling)
            sys2 = apply_strain(sys2, scaling)
        saved = SavedTensorBytes()
        with saved.counting() if hessian else contextlib.nullcontext():
            data = aimnet2_apply(params, cfg, sys2, sae_external=sae_external, conv_precision=conv_precision)
            grads = torch.autograd.grad(data["energy"].sum(), inputs, create_graph=hessian)
        out = collect(data)
        if forces or (hessian and not stress):
            out["forces"] = -grads[0].detach()
        if stress:
            volume = torch.abs(torch.linalg.det(system.cell))[:, None, None]
            out["stress"] = grads[1].detach() / volume
        if hessian:
            real = system.numbers > 0
            chunk = hessian_chunk(system, 3 * int(real.sum()), saved.total)
            out["hessian"] = dense_hessian(grads[0], coord, real, chunk)
        return out

    return eval_fn


def make_hvp_fn(cfg: AIMNet2Config, sae_external: bool = True,
                matmul_precision: str | None = None) -> Callable[[dict, System, torch.Tensor], torch.Tensor]:
    """Matrix-free Hessian-vector product ``hvp(params, system, v) -> H v``
    (N, 3): the gradient of ``<dE/dcoord, v>``, one double backward.  On a
    binned layout ``v`` is in slot order and the kernels' K3 rules carry
    the second order.  ``matmul_precision`` as :func:`make_eval_fn`'s."""

    def hvp(params: dict, system: System, v: torch.Tensor) -> torch.Tensor:
        with _ambient(matmul_precision):
            return hvp_inner(params, system, v)

    def hvp_inner(params: dict, system: System, v: torch.Tensor) -> torch.Tensor:
        coord = system.coord.detach().requires_grad_(True)
        energy = aimnet2_apply(params, cfg, system.replace(coord=coord), sae_external=sae_external)["energy"]
        (grad,) = torch.autograd.grad(energy.sum(), coord, create_graph=True)
        (hv,) = torch.autograd.grad(grad, coord, v.to(coord.dtype))
        return hv

    return hvp


def _ambient(matmul_precision: str | None):
    """A tier's matmul context, or the caller's ambient for ``None``."""
    if matmul_precision is None:
        return contextlib.nullcontext()
    from aimnetcentral_tpu_torch.calculators.calculator import ambient_matmul_context

    return ambient_matmul_context(matmul_precision)


def real_atom_hessian(h: torch.Tensor, n_real: int) -> torch.Tensor:
    """Slice the padded (N, 3, N, 3) Hessian down to real atoms."""
    return h[:n_real, :, :n_real, :]
