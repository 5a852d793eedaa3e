"""Transition-state search by minimum-mode following with Lanczos HVPs
(counterpart of aimnetcentral_tpu/dynamics/saddle.py).

The lowest Hessian eigenpair comes from a fixed-iteration Lanczos built on
matrix-free Hessian-vector products (each the gradient of ``<dE/dx, v>``,
the primitive of ``calculators/derivatives.py::make_hvp_fn``), so memory
is O(k N) for the Lanczos basis instead of O(N^2) for a dense Hessian.  The
JAX package fuses the loop into one ``lax.while_loop``; here it is a Python
loop of eager steps on the system's device that reads the largest force
norm on the host once a step.  The random start comes from a
``torch.Generator`` seeded with ``seed``, so it is not JAX's draw: the
search agrees with JAX's in distribution, and ``lanczos_min_mode`` with the
same ``v0`` agrees with JAX's to float32 rounding.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from aimnetcentral_tpu_torch.models.aimnet2 import AIMNet2Config, aimnet2_apply
from aimnetcentral_tpu_torch.system import System


def _norm(v: torch.Tensor) -> torch.Tensor:
    return torch.sqrt((v * v).sum())


def lanczos_min_mode(
    hvp: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    coord: torch.Tensor,
    v0: torch.Tensor,
    real: torch.Tensor,
    k: int = 15,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Lowest Hessian eigenpair by k-step Lanczos with full reorthogonalization.

    ``hvp(coord, v) -> H @ v`` (padding rows must map to zero); ``v0`` the
    starting direction (warm-started across TS steps); ``real`` (N, 1) bool.
    Returns (lambda_min, v_min) with ``v_min`` unit-normalized over real atoms.
    """
    q_cur = torch.where(real, v0, 0.0)
    q_cur = q_cur / torch.clamp(_norm(q_cur), min=1e-12)
    q_prev = torch.zeros_like(q_cur)
    beta_prev = torch.zeros((), dtype=coord.dtype, device=coord.device)
    qs = torch.zeros((k,) + tuple(coord.shape), dtype=coord.dtype, device=coord.device)
    alphas = torch.zeros(k, dtype=coord.dtype, device=coord.device)
    betas = torch.zeros(k, dtype=coord.dtype, device=coord.device)
    for i in range(k):
        w = torch.where(real, hvp(coord, q_cur), 0.0)
        alpha = (w * q_cur).sum()
        w = w - alpha * q_cur - beta_prev * q_prev
        # full reorthogonalization against the stored basis (k is small)
        proj = torch.einsum("kni,ni->k", qs, w)
        w = w - torch.einsum("k,kni->ni", proj, qs)
        beta = _norm(w)
        q_next = torch.where(beta > 1e-10, w / torch.clamp(beta, min=1e-12), q_cur)
        qs[i], alphas[i], betas[i] = q_cur, alpha, beta
        q_prev, q_cur, beta_prev = q_cur, q_next, beta

    # tridiagonal T: diag = alphas, off-diagonal = betas[:-1]
    t_mat = torch.diag(alphas) + torch.diag(betas[:-1], 1) + torch.diag(betas[:-1], -1)
    evals, evecs = torch.linalg.eigh(t_mat)
    v_min = torch.einsum("k,kni->ni", evecs[:, 0], qs)
    v_min = torch.where(real, v_min, 0.0)
    v_min = v_min / torch.clamp(_norm(v_min), min=1e-12)
    return evals[0], v_min


def min_mode_search(
    energy_fn: Callable[[torch.Tensor], torch.Tensor],
    coord0: torch.Tensor,
    real: torch.Tensor,
    fmax: float = 0.01,
    max_steps: int = 200,
    step_size: float = 0.35,
    trust: float = 0.12,
    lanczos_k: int = 15,
    seed: int = 0,
) -> tuple[torch.Tensor, dict[str, Any]]:
    """Min-mode (dimer-style) saddle search on an arbitrary energy function
    ``energy_fn(coord) -> scalar``.  Returns (coord, info).

    With the lowest eigenpair (lam, v), the effective force is
    ``F - 2 (F.v) v`` once a negative mode exists, and pure mode-climbing
    ``-(F.v) v`` while the surface is still locally convex.  Steps are
    steepest-ascent/descent on the effective force with a per-step trust
    radius (max total displacement norm).
    """

    def grad_of(coord: torch.Tensor, create_graph: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
        c = coord.detach().requires_grad_(True)
        (g,) = torch.autograd.grad(energy_fn(c), c, create_graph=create_graph)
        return c, g

    def force_of(coord: torch.Tensor) -> torch.Tensor:
        return torch.where(real, -grad_of(coord)[1], 0.0)

    def hvp(coord: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        c, g = grad_of(coord, create_graph=True)
        (hv,) = torch.autograd.grad(g, c, v)
        return torch.where(real, hv, 0.0)

    gen = torch.Generator(device=coord0.device).manual_seed(seed)
    v = torch.randn(coord0.shape, generator=gen, dtype=coord0.dtype, device=coord0.device)
    v = torch.where(real, v, 0.0)

    def fmax_of(f: torch.Tensor) -> float:
        return float(torch.sqrt((f * f).sum(-1).max()))

    coord = coord0.detach()
    step, fnorm = 0, float("inf")
    while fnorm > fmax and step < max_steps:
        f = force_of(coord)
        lam, v = lanczos_min_mode(hvp, coord, v, real, k=lanczos_k)
        f_par = (f * v).sum() * v
        f_eff = torch.where(lam < 0.0, f - 2.0 * f_par, -f_par)
        dx = step_size * f_eff
        dx = dx * torch.clamp(trust / torch.clamp(_norm(dx), min=1e-12), max=1.0)
        coord = coord + torch.where(real, dx, 0.0)
        fnorm = fmax_of(f)  # the step's one host read
        step += 1

    fmax_final = fmax_of(force_of(coord))
    lam_final = float(lanczos_min_mode(hvp, coord, v, real, k=lanczos_k)[0])
    info = {
        "steps": step,
        "fmax": fmax_final,
        "lambda_min": lam_final,
        "converged": fmax_final <= fmax,
        "is_saddle": fmax_final <= fmax and lam_final < 0.0,
    }
    return coord, info


def ts_search(
    params: Any,
    cfg: AIMNet2Config,
    system: System,
    fmax: float = 0.01,
    max_steps: int = 200,
    **kwargs: Any,
) -> tuple[System, dict[str, Any]]:
    """Transition-state refinement of ``system`` on the model surface, on
    its device.  Pass an indexed System (``builders.system_from_molecules(
    ..., build_nbmat=True)``), as JAX's XLA engine runs it; on a binned one
    the HVPs take the kernels' K3 rules.  The layout is fixed over the
    search: its lists must reach every pair the search brings within the
    cutoff (all-pairs lists of a molecule always do)."""
    real = (system.numbers > 0)[:, None]

    def energy_of(coord: torch.Tensor) -> torch.Tensor:
        return aimnet2_apply(params, cfg, system.replace(coord=coord), sae_external=True)["energy"].sum()

    coord, info = min_mode_search(energy_of, system.coord, real, fmax=fmax, max_steps=max_steps, **kwargs)
    return system.replace(coord=coord), info
