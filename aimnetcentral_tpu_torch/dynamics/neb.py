"""Batched climbing-image NEB (counterpart of
aimnetcentral_tpu/dynamics/neb.py).

The whole band evaluates as one batched indexed System per iteration (K
images = K molecules with all-pairs intra-molecular lists, so no list
rebuilds as the path deforms): one forward and one backward a step.  The
tangent projection, spring forces, climbing-image switch and the global
FIRE update are tensor ops on the band's device; the JAX package fuses the
loop into one ``lax.while_loop``, here it is a Python loop that reads the
largest NEB force norm on the host once a step.

Methods: improved tangent (Henkelman & Jonsson, J. Chem. Phys. 113, 9978,
2000) and climbing image (Henkelman, Uberuaga & Jonsson, J. Chem. Phys.
113, 9901, 2000), with a global FIRE integrator (Bitzek et al. 2006) over
the interior images.
"""

from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch

from aimnetcentral_tpu_torch.builders import system_from_molecules
from aimnetcentral_tpu_torch.device import resolve_device
from aimnetcentral_tpu_torch.models.aimnet2 import AIMNet2Config, aimnet2_apply
from aimnetcentral_tpu_torch.models.bridge import params_to


def linear_band(coord_r: torch.Tensor, coord_p: torch.Tensor, n_images: int) -> torch.Tensor:
    """(K, N, 3) linear interpolation between reactant and product,
    endpoints included."""
    w = torch.linspace(0.0, 1.0, n_images, dtype=coord_r.dtype, device=coord_r.device)[:, None, None]
    return (1.0 - w) * coord_r[None] + w * coord_p[None]


def _tangents(band: torch.Tensor, energies: torch.Tensor) -> torch.Tensor:
    """Improved-tangent estimate for the K-2 interior images
    (Henkelman & Jonsson 2000, eqs. 8-11).  Returns unit tangents
    (K-2, N, 3)."""
    tau_plus = band[2:] - band[1:-1]
    tau_minus = band[1:-1] - band[:-2]
    e_prev, e_i, e_next = energies[:-2], energies[1:-1], energies[2:]

    de_max = torch.maximum(torch.abs(e_next - e_i), torch.abs(e_prev - e_i))[:, None, None]
    de_min = torch.minimum(torch.abs(e_next - e_i), torch.abs(e_prev - e_i))[:, None, None]
    uphill = (e_next > e_prev)[:, None, None]
    mixed = torch.where(uphill, tau_plus * de_max + tau_minus * de_min, tau_plus * de_min + tau_minus * de_max)
    tau = torch.where(
        ((e_next > e_i) & (e_i > e_prev))[:, None, None],
        tau_plus,
        torch.where(((e_next < e_i) & (e_i < e_prev))[:, None, None], tau_minus, mixed),
    )
    norm = torch.sqrt((tau * tau).sum(dim=(1, 2), keepdim=True))
    return tau / torch.clamp(norm, min=1e-10)


def neb_forces(
    band: torch.Tensor,
    energies: torch.Tensor,
    f_true: torch.Tensor,
    k_spring: float,
    climb: bool,
) -> torch.Tensor:
    """Project true forces into NEB forces.  ``band``/``f_true`` are
    (K, N, 3), ``energies`` (K,).  Endpoint rows come back zero (frozen)."""
    tau = _tangents(band, energies)
    f_int = f_true[1:-1]
    f_par = (f_int * tau).sum(dim=(1, 2), keepdim=True)
    f_perp = f_int - f_par * tau

    d_plus = torch.sqrt(((band[2:] - band[1:-1]) ** 2).sum(dim=(1, 2)))
    d_minus = torch.sqrt(((band[1:-1] - band[:-2]) ** 2).sum(dim=(1, 2)))
    f_spring = k_spring * (d_plus - d_minus)[:, None, None] * tau

    f_neb = f_perp + f_spring
    if climb:
        # highest-energy interior image: full true force with the parallel
        # component inverted, no springs; it rides the band up the tangent
        i_max = torch.argmax(energies[1:-1])
        mask = (torch.arange(band.shape[0] - 2, device=band.device) == i_max)[:, None, None]
        f_neb = torch.where(mask, f_int - 2.0 * f_par * tau, f_neb)

    zero = torch.zeros_like(band[:1])
    return torch.cat([zero, f_neb, zero], dim=0)


def neb_core(
    energy_forces_fn: Callable[[torch.Tensor], tuple[torch.Tensor, torch.Tensor]],
    band0: torch.Tensor,
    k_spring: float = 0.1,
    climb: bool = True,
    fmax: float = 0.05,
    max_steps: int = 500,
    dt_start: float = 0.05,
    dt_max: float = 0.2,
    n_min: int = 5,
    f_inc: float = 1.1,
    f_dec: float = 0.5,
    alpha_start: float = 0.1,
    f_alpha: float = 0.99,
) -> tuple[torch.Tensor, torch.Tensor, dict[str, Any]]:
    """Optimize a band with global FIRE under the NEB force field.

    ``energy_forces_fn(band) -> ((K,), (K, N, 3))`` evaluates all images at
    once.  Returns (band, per-image energies, info).  Convergence is the
    max per-atom NEB-force norm over interior images."""

    def neb_f(band: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        e, f = energy_forces_fn(band)
        return e, neb_forces(band, e, f, k_spring, climb)

    def fmax_of(f: torch.Tensor) -> float:
        return float(torch.sqrt((f[1:-1] * f[1:-1]).sum(-1).max()))

    def scalar(x, dtype=torch.float32) -> torch.Tensor:
        return torch.tensor(x, dtype=dtype, device=band0.device)

    band = band0
    v = torch.zeros_like(band0)
    dt, alpha, npos = scalar(dt_start), scalar(alpha_start), scalar(0, torch.int32)
    step, fnorm = 0, float("inf")
    while fnorm > fmax and step < max_steps:
        _e, f = neb_f(band)
        p = (f * v).sum()
        f_unit = f / torch.clamp(torch.linalg.norm(f), min=1e-10)
        v_mixed = (1.0 - alpha) * v + alpha * torch.linalg.norm(v) * f_unit

        uphill = p <= 0.0
        grow = npos > n_min
        v = torch.where(uphill, 0.0, v_mixed)
        dt = torch.where(uphill, dt * f_dec, torch.where(grow, torch.clamp(dt * f_inc, max=dt_max), dt))
        alpha = torch.where(uphill, alpha_start, torch.where(grow, alpha * f_alpha, alpha))
        npos = torch.where(uphill, 0, npos + 1)

        v = v + dt * f
        band = band + dt * v
        fnorm = fmax_of(f)  # the step's one host read
        step += 1

    energies, f_final = neb_f(band)
    fmax_final = fmax_of(f_final)
    i_ts = int(torch.argmax(energies[1:-1])) + 1
    info = {
        "steps": step,
        "fmax": fmax_final,
        "converged": fmax_final <= fmax,
        "i_ts": i_ts,
        "barrier": float(energies[i_ts] - energies[0]),
        "barrier_reverse": float(energies[i_ts] - energies[-1]),
    }
    return band, energies, info


def band_energy_forces(
    params: Any, cfg: AIMNet2Config, reactant: dict, n_images: int, device: torch.device
) -> Callable[[torch.Tensor], tuple[torch.Tensor, torch.Tensor]]:
    """``energy_forces(band) -> ((K,), (K, N, 3))`` of a band of the
    reactant's atoms: one batched indexed System of ``n_images`` molecules
    with all-pairs intra-molecular lists, built once; energies without the
    SAE shift."""
    numbers = np.asarray(reactant["numbers"], dtype=np.int64)
    n = len(numbers)
    mol = {"coord": np.asarray(reactant["coord"], dtype=np.float32), "numbers": numbers}
    for key in ("charge", "mult"):
        if key in reactant:
            mol[key] = reactant[key]
    system = system_from_molecules([mol] * n_images, device, n_pad=n_images * n + 1, build_nbmat=True)

    def energy_forces(band: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        flat = system.coord.clone()
        flat[: n_images * n] = band.reshape(n_images * n, 3)
        flat.requires_grad_(True)
        energies = aimnet2_apply(params, cfg, system.replace(coord=flat), sae_external=True)["energy"]
        (grads,) = torch.autograd.grad(energies.sum(), flat)
        return energies.detach(), -grads[: n_images * n].reshape(n_images, n, 3)

    return energy_forces


def neb(
    params: Any,
    cfg: AIMNet2Config,
    reactant: dict,
    product: dict,
    n_images: int = 11,
    band0: torch.Tensor | np.ndarray | None = None,
    device: str | torch.device = "cuda",
    **core_kwargs: Any,
) -> tuple[torch.Tensor, torch.Tensor, dict[str, Any]]:
    """Climbing-image NEB between two gas-phase endpoints, on ``device``
    ("cuda" unless the caller asks for "cpu").

    ``reactant``/``product``: molecule dicts (``coord`` (N, 3), ``numbers``
    (N,), optional ``charge``/``mult``) with identical atom ordering.  The
    band is packed as ONE batched System and every iteration is a single
    batched force call.  Endpoints should be pre-relaxed (``fire_relax``).
    Returns (band (K, N, 3), energies (K,), info); energies exclude the SAE
    shift (constant across a band; barriers are unaffected).
    ``info["i_ts"]`` hands the climbing image to ``ts_search``."""
    dev = resolve_device(device)
    coord_r = np.asarray(reactant["coord"], dtype=np.float32)
    coord_p = np.asarray(product["coord"], dtype=np.float32)
    numbers = np.asarray(reactant["numbers"], dtype=np.int32)
    if not np.array_equal(numbers, np.asarray(product["numbers"], dtype=np.int32)):
        raise ValueError("reactant and product must share atom ordering")
    if "cell" in reactant or "cell" in product:
        raise ValueError("NEB supports gas-phase endpoints (no cell)")
    # the whole band runs at the reactant's charge and mult, so endpoints on
    # different electronic states must be refused
    for key in ("charge", "mult"):
        a = float(reactant.get(key, 1.0 if key == "mult" else 0.0))
        b = float(product.get(key, 1.0 if key == "mult" else 0.0))
        if a != b:
            raise ValueError(
                f"reactant and product disagree on {key} ({a} vs {b}); "
                "NEB requires one electronic state along the band"
            )

    if band0 is None:
        band0 = linear_band(torch.as_tensor(coord_r, device=dev), torch.as_tensor(coord_p, device=dev), n_images)
    else:
        band0 = torch.as_tensor(band0, dtype=torch.float32, device=dev)
        n_images = band0.shape[0]
    fn = band_energy_forces(params_to(params, dev), cfg, reactant, n_images, dev)
    return neb_core(fn, band0, **core_kwargs)
