"""The fused ensemble forward (counterpart of
aimnetcentral_tpu/models/ensemble_fused.py): one geometry shared by all E
members, one member-stacked conv pass, per-member MLPs and heads.

Two structural facts make the fusion exact:

1. The ConvSV contraction is independent per feature channel.  Stacking the
   members' features member-major along the channel axis ((N, E*F, G)) and
   their ``agh`` tensors the same way makes one conv pass compute every
   member's messages: on the binned layout one launch of kernels A and B
   (kernels/conv_stencil.py, column-tiled for the stacked widths) serves
   all members' features and charges.
2. The long-range pair terms are bilinear in the charges (or, for D3TS,
   share the damping): the member forms of kernels D and E
   (kernels/pair_sweep.py::MemberTerm) evaluate a pair's geometry and
   member-independent factor once and each member's product from it.

The MLPs, NSE charge equilibration and the other heads run per member, as
batched matrix products over the member axis (no vmap).  Parameters carry
a leading member axis on every leaf (``calculators/ensemble.py::
stack_params``); every member shares one architecture, so the AEV
constants of member 0 serve all (``dynamics/md.py`` checks that they
agree).  Member-dependent outputs carry a leading member axis: ``energy``
(E, num_mol), ``charges`` (E, N), ``aim`` (E, N, A).
"""

from __future__ import annotations

from typing import Any

import torch

from aimnetcentral_tpu_torch.kernels.conv_pass import conv_pass
from aimnetcentral_tpu_torch.models import engine_binned as eb
from aimnetcentral_tpu_torch.models import ewald, lr
from aimnetcentral_tpu_torch.models.aimnet2 import (
    AIMNet2Config,
    _calc_aev,
    _conv_sv,
    check_conv_precision,
    _conv_engine,
    mlp_spec_for_pass,
)
from aimnetcentral_tpu_torch.models.heads import HeadSpec, _center_coordinates, head_apply
from aimnetcentral_tpu_torch.models.modules import MLPSpec, get_activation
from aimnetcentral_tpu_torch.ops import math as aops
from aimnetcentral_tpu_torch.ops import nb as nbops
from aimnetcentral_tpu_torch.system import System


def ensemble_size(params: dict) -> int:
    return params["afv"]["weight"].shape[0]


def member_params(tree: Any, e: int) -> Any:
    """Member ``e``'s parameters from a stacked tree."""
    if isinstance(tree, dict):
        return {k: member_params(v, e) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(member_params(v, e) for v in tree)
    return tree[e]


def _stack_channels(x_e: torch.Tensor) -> torch.Tensor:
    """(E, N, F[, G]) -> (N, E*F[, G]), member-major channel order."""
    x = x_e.movedim(0, 1)  # (N, E, F[, G])
    return x.reshape((x.shape[0], x.shape[1] * x.shape[2]) + tuple(x.shape[3:]))


def _split_conv_out(out: torch.Tensor, n_e: int, f_dim: int, g_dim: int, h_dim: int) -> torch.Tensor:
    """A member-stacked conv output (N, E*F*G + E*F*H) -> per-member conv
    vectors (E, N, F*G + F*H): both layouts emit channel-major scalar and
    vector blocks, so the member axis factors out of each."""
    n = out.shape[0]
    s_part = out[:, : n_e * f_dim * g_dim].reshape(n, n_e, f_dim * g_dim)
    v_part = out[:, n_e * f_dim * g_dim :].reshape(n, n_e, f_dim * h_dim)
    return torch.cat([s_part, v_part], dim=-1).movedim(1, 0)


def _mask_pad(x: torch.Tensor, numbers: torch.Tensor) -> torch.Tensor:
    """Zero the padding atoms' rows of a member-stacked (E, N, ...) tensor."""
    mask = (numbers == 0).reshape((1, numbers.shape[0]) + (1,) * (x.dim() - 2))
    return torch.where(mask, torch.zeros_like(x), x)


def mlp_apply_members(layers: list[dict[str, torch.Tensor]], x: torch.Tensor, spec: MLPSpec) -> torch.Tensor:
    """Every member's MLP on its own input: layers of (E, n_in, n_out)
    weights and (E, n_out) biases, x (E, N, n_in), one batched product a
    layer."""
    act = get_activation(spec.activation)
    n = len(layers)
    for i, layer in enumerate(layers):
        x = torch.baddbmm(layer["b"][:, None, :], x, layer["w"])
        if not (spec.last_linear and i == n - 1):
            x = act(x)
    return x


def _members_as_channels(x_e: torch.Tensor) -> torch.Tensor:
    """(E, N, c) -> (N, E*c): NSE and the molecule sums act per channel,
    so the members ride as channels."""
    return x_e.movedim(0, 1).reshape(x_e.shape[1], -1)


def _channels_as_members(x: torch.Tensor, n_e: int) -> torch.Tensor:
    """(N, E*c) -> (E, N, c)."""
    return x.reshape(x.shape[0], n_e, -1).movedim(1, 0)


def aimnet2_apply_ensemble(params: dict, cfg: AIMNet2Config, system: System, sae_external: bool = False,
                           conv_precision: str | None = None) -> dict:
    """The fused ensemble forward over member-stacked ``params`` (leading
    axis E) on a binned or an indexed System.  Returns the data dict with a
    leading member axis on the member-dependent keys (``energy`` (E,
    num_mol), ``charges`` and ``spin_charges`` (E, N), ``aim`` (E, N, A));
    ``mol_element_counts`` stays unstacked.  Agrees with
    ``aimnet2_apply`` of each member (tests/test_torch_ensemble.py).
    ``conv_precision`` as :func:`aimnet2_apply`'s."""
    check_conv_precision(_conv_engine(system), conv_precision)
    n = system.natoms
    c = cfg.num_charge_channels
    n_e = ensemble_size(params)
    f_dim, g_dim, h_dim = cfg.nfeature, cfg.nshifts, cfg.ncomb_v
    aev0 = {k: v[0] for k, v in params["aev"].items()}  # one architecture: the members' constants agree
    agh_a_st = params["conv_a"]["agh"].reshape(n_e * f_dim, g_dim, h_dim)
    agh_q_st = params["conv_q"]["agh"].reshape(n_e * c, g_dim, h_dim)

    a_e = params["afv"]["weight"][:, system.numbers]  # (E, N, F[*G])
    if cfg.d2features:
        a_e = a_e.reshape(n_e, n, f_dim, g_dim)

    if c == 2:
        if system.mult is None:
            raise ValueError("mult is required for NSE (two charge channel) models")
        half_spin = 0.5 * (system.mult - 1.0)
        half_q = 0.5 * system.charge
        big_q = torch.stack([half_q + half_spin, half_q - half_spin], dim=-1)
    else:
        big_q = system.charge[:, None]
    big_q_st = big_q.repeat(1, n_e)  # (M, E*c), member-major as _members_as_channels

    binned = system.bins is not None
    data: dict = {"_sae_external": sae_external, "_ensemble": n_e}
    if not binned:
        d_ij, r_ij = aops.calc_distances(system.coord, system.nbmat, system.shifts, system.cell, system.mol_idx)
        g_sv = _calc_aev({"aev": aev0}, d_ij, r_ij, nbops.pair_mask(system.nbmat))
        data["d_ij"] = d_ij

    charges_e = None  # (E, N, c)
    delta_q_log = []
    npass = len(cfg.hidden)
    for ipass in range(npass):
        a_st = _stack_channels(a_e)  # (N, E*F[, G])
        q_st = _members_as_channels(charges_e) if ipass > 0 else None  # (N, E*c)
        if binned:
            conv_a, conv_q = conv_pass(system, aev0, a_st, q_st, agh_a_st, agh_q_st, rc_static=cfg.aev.rc_s,
                                       conv_precision=conv_precision)
        else:
            conv_a = _conv_sv(agh_a_st, a_st, g_sv, system.nbmat, cfg.d2features)
            conv_q = _conv_sv(agh_q_st, q_st, g_sv, system.nbmat, False) if ipass > 0 else None
        conv_a_e = _split_conv_out(conv_a, n_e, f_dim, g_dim, h_dim)
        a_flat_e = a_e.reshape(n_e, n, -1)
        if ipass == 0:
            x_e = torch.cat([a_flat_e, conv_a_e], dim=-1)
        else:
            conv_q_e = _split_conv_out(conv_q, n_e, c, g_dim, h_dim)
            x_e = torch.cat([a_flat_e, conv_a_e, charges_e, conv_q_e], dim=-1)
        out_e = mlp_apply_members(params["mlps"][ipass], x_e, mlp_spec_for_pass(cfg, ipass))
        out_e = _mask_pad(out_e, system.numbers)
        if ipass == npass - 1:
            data["aim"] = out_e
        else:
            _q, _f, delta_a = out_e[..., :c], out_e[..., c : 2 * c], out_e[..., 2 * c :]
            q_u = _members_as_channels(_q)
            delta_q_log.append(big_q_st - nbops.mol_sum(q_u, system.mol_idx, system.num_mol))
            if ipass > 0:
                q_u = _members_as_channels(charges_e) + q_u
            q, _dq = aops.nse(big_q_st, q_u, _members_as_channels(_f * _f), system.mol_idx, system.num_mol)
            charges_e = _channels_as_members(q, n_e)
            a_e = a_e + delta_a.reshape(a_e.shape)

    if c == 2:
        data["spin_charges"] = charges_e[..., 0] - charges_e[..., 1]
        data["charges"] = charges_e.sum(dim=-1)
    else:
        data["charges"] = charges_e.squeeze(-1)
    # (passes, M, E, c) -> (passes, E, M, c), JAX's stacked layout
    data["_delta_Q"] = (
        torch.stack([_channels_as_members(x, n_e) for x in delta_q_log], dim=0) if delta_q_log else None
    )

    for name, head in cfg.outputs:
        data = ensemble_head_apply(head, params["outputs"][name], data, system, n_e)
    return data


# ---------------------------------------------------------------------------
# the heads over the member-stacked data


def _add_energy_e(data: dict, key_out: str, e: torch.Tensor, n_e: int) -> dict:
    """Add a per-member (E, M), or member-independent (M,) and broadcast,
    energy term to the stacked data."""
    if e.dim() == 1:
        e = e[None].expand((n_e,) + tuple(e.shape))
    if key_out in data:
        return {**data, key_out: data[key_out] + e}
    return {**data, key_out: e}


def _mol_sum_e(x_e: torch.Tensor, system: System) -> torch.Tensor:
    """Per-molecule sums of a member-stacked per-atom tensor: (E, N[, D]) ->
    (E, M[, D]), one reduction."""
    s = nbops.mol_sum(x_e.movedim(0, 1), system.mol_idx, system.num_mol)
    return s.movedim(1, 0)


def _shared_key(k: str) -> bool:
    """Keys every member shares: geometry caches, flags, the SAE counts."""
    return k.startswith("d_ij") or k.startswith("_") or k == "mol_element_counts"


def _member_view(data: dict, e: int) -> dict:
    """Member ``e``'s view of the stacked data, for the heads that run per
    member or once; the shared keys are passed through."""
    return {k: (v if _shared_key(k) or not isinstance(v, torch.Tensor) else v[e]) for k, v in data.items()}


def ensemble_head_apply(head: HeadSpec, params: dict, data: dict, system: System, n_e: int) -> dict:
    """One output head over the member-stacked data.  Member-independent
    heads (SRRep, D3: constant tables, geometry-only energies) run once and
    are broadcast; the charge-bilinear long-range heads and D3TS run their
    member forms; everything else runs per member."""
    p0 = member_params(params, 0)

    if head.kind == "output":
        v = mlp_apply_members(params["mlp"], data[head.key_in], head.mlp)
        if head.n_out == 1:
            v = v.squeeze(-1)
        return {**data, head.key_out: _mask_pad(v, system.numbers)}

    if head.kind == "atomic_shift":
        if data.get("_sae_external", False):
            counts = head_apply(head, p0, {"_sae_external": True}, system)["mol_element_counts"]
            return {**data, "mol_element_counts": counts}
        shifts = params["weight"][:, system.numbers]  # (E, N)
        if head.reduce_sum:
            shifts = _mol_sum_e(shifts, system)
        return {**data, head.key_out: data[head.key_in] + shifts}

    if head.kind == "atomic_sum":
        return {**data, head.key_out: _mol_sum_e(data[head.key_in], system)}

    if head.kind in ("dipole", "quadrupole"):
        q, r = data[head.key_in], system.coord  # (E, N)
        if head.center_coord:
            r = _center_coordinates(r, system, p0["mass"][system.numbers])
        if head.kind == "dipole":
            return {**data, head.key_out: _mol_sum_e(q[..., None] * r[None], system)}
        x = torch.cat([r * r, r * torch.roll(r, -1, dims=-1)], dim=-1)
        quad = _mol_sum_e(q[..., None] * x[None], system)
        x1, x2 = quad[..., :3], quad[..., 3:]
        return {**data, head.key_out: torch.cat([x1 - x1.mean(dim=-1, keepdim=True), x2], dim=-1)}

    if head.kind in ("srrep", "dftd3"):
        # member-independent: once; key_out leaves the view first, so the
        # result is the bare term, added back broadcast over the members
        view = _member_view(data, 0)
        view.pop(head.key_out, None)
        d0 = head_apply(head, p0, view, system)
        return _add_energy_e(data, head.key_out, d0[head.key_out], n_e)

    if head.kind == "disp_param":
        mult = torch.exp(torch.clamp(data[head.key_in], -4.0, 4.0))  # (E, N, 2)
        return {**data, head.key_out: p0["disp_param0"][system.numbers][None] * mult}

    if system.bins is not None and head.kind == "lrcoulomb":
        q_st = data[head.key_in].movedim(0, 1)  # (N, E)
        if head.method == "dsf":
            e = eb.coulomb_dsf_binned_multi(
                system, q_st, head.rc, head.dsf_alpha, head.dsf_rc, head.envelope, head.subtract_sr
            )
        elif head.method == "simple" and system.bins.molecule_bins:
            e = eb.coulomb_simple_binned_multi(system, q_st, head.rc, head.envelope, head.subtract_sr)
        elif head.method in ("ewald", "pme"):  # the SR part inside the real-space sweep, as single models
            e = ewald.coulomb_periodic_binned_multi(system, q_st, head.subtract_sr, head.rc, head.envelope)
        else:
            return _per_member_fallback(head, params, data, system, n_e)
        return _add_energy_e(data, head.key_out, e.movedim(1, 0), n_e)

    if head.kind == "srcoulomb":
        q_st = data[head.key_in].movedim(0, 1)
        if system.bins is not None:
            e = eb.coulomb_sr_binned_multi(system, q_st, head.rc, head.envelope)
        else:
            data = lr.ensure_dij(data, system, "")
            e = lr.coulomb_sr_multi(data, system, head.rc, head.envelope, q_st)
        return _add_energy_e(data, head.key_out, -e.movedim(1, 0), n_e)

    if head.kind == "d3ts" and system.bins is not None:
        dp_st = data[head.key_in].movedim(0, 1)  # (N, E, 2)
        e = eb.d3ts_binned_multi(system, p0, dp_st, head.a1, head.a2, head.s8, head.s6)
        return _add_energy_e(data, head.key_out, e.movedim(1, 0), n_e)

    if head.kind == "lrcoulomb" and head.method in ("ewald", "pme"):  # the indexed layout
        q_st = data[head.key_in].movedim(0, 1)
        e = ewald.coulomb_periodic_multi(q_st, system, method=head.method)
        if head.subtract_sr:
            data = lr.ensure_dij(data, system, "")
            e = e - lr.coulomb_sr_multi(data, system, head.rc, head.envelope, q_st)
        return _add_energy_e(data, head.key_out, e.movedim(1, 0), n_e)

    return _per_member_fallback(head, params, data, system, n_e)


def _per_member_fallback(head: HeadSpec, params: dict, data: dict, system: System, n_e: int) -> dict:
    """The head once per member, with the geometry caches shared: a
    distance a member computes is kept for the next."""
    shared = {k: v for k, v in data.items() if _shared_key(k)}
    member_keys = [k for k, v in data.items() if k not in shared and isinstance(v, torch.Tensor)]
    energies = []
    for e_idx in range(n_e):
        view = {**shared, **{k: data[k][e_idx] for k in member_keys}}
        view.pop(head.key_out, None)  # the result is then the bare term
        d_e = head_apply(head, member_params(params, e_idx), view, system)
        for k, v in d_e.items():
            if k.startswith("d_ij") and k not in shared:
                shared[k] = v
        energies.append(d_e[head.key_out])
    return _add_energy_e(data, head.key_out, torch.stack(energies), n_e)
