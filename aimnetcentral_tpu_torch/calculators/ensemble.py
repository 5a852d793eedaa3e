"""The ensemble calculator: member-stacked parameters, mean outputs and
their spread (counterpart of aimnetcentral_tpu/calculators/ensemble.py).

The released model families ship four members each (``aimnet2`` is
``aimnet2-wb97m-d3_{0..3}``).  Two paths:

- per member (the default): each member runs the single-model evaluation
  (``derivatives.make_eval_fn``, every kernel launch a single model's) in
  turn; the outputs are the members' means, with ``energy_std``,
  ``forces_std`` and ``charges_std``;
- fused (``fused=True``): one forward of models/ensemble_fused.py (one
  geometry, one member-stacked conv pass, the member forms of the pair
  sweeps) and one backward of the member-mean energy, so it emits
  ``energy_std`` and ``charges_std`` but no ``forces_std``.  Stress and
  Hessian requests go to the per-member path, as in the JAX package.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from aimnetcentral_tpu_torch.calculators import derivatives
from aimnetcentral_tpu_torch.calculators.calculator import AIMNet2Calculator, ambient_matmul_context, precision_tiers
from aimnetcentral_tpu_torch.models.aimnet2 import AIMNet2Config
from aimnetcentral_tpu_torch.models.ensemble_fused import aimnet2_apply_ensemble, member_params
from aimnetcentral_tpu_torch.models.heads import head_init
from aimnetcentral_tpu_torch.system import System

_KEEP = ("charges", "spin_charges", "dipole", "quadrupole")  # the fused path's per-member outputs, meaned


def stack_params(params_list: list[Any]) -> Any:
    """Stack the members' parameter trees on a leading member axis."""
    first = params_list[0]
    if isinstance(first, dict):
        return {k: stack_params([p[k] for p in params_list]) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(stack_params(list(xs)) for xs in zip(*params_list))
    return torch.stack([torch.as_tensor(p) for p in params_list])


def _leaves(tree: Any) -> list[torch.Tensor]:
    """The tensors of a tree, dict keys in sorted order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _broadcast(tree: Any, n: int) -> Any:
    if isinstance(tree, dict):
        return {k: _broadcast(v, n) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_broadcast(v, n) for v in tree)
    return tree[None].expand((n,) + tuple(tree.shape)).contiguous()


def _std(x: torch.Tensor) -> torch.Tensor:
    """The members' spread, population form (JAX's ``std``)."""
    return x.std(dim=0, correction=0)


class EnsembleCalculator(AIMNet2Calculator):
    """The calculator over member-stacked parameters: outputs are the
    members' means, with ``energy_std`` (and, per member, ``forces_std``
    and ``charges_std``) as the uncertainty.  Build it with
    ``from_members`` or ``from_registry``; ``fused`` picks the fused path
    for energy and forces."""

    def __init__(self, model, *args, fused: bool = False, **kwargs):
        super().__init__(model, *args, **kwargs)
        self._fused = fused
        self._stack_attached_heads()

    def _stack_attached_heads(self) -> None:
        """A head the constructor attached (the metadata's or the caller's
        external long-range flags) has unstacked constant tables: broadcast
        them onto the member axis, so that every leaf has one."""
        afv = self.params["afv"]["weight"]
        if afv.dim() != 3:  # not member-stacked
            return
        n = afv.shape[0]
        gen = torch.Generator().manual_seed(0)
        outs = dict(self.params["outputs"])
        for name, head in self.cfg.outputs:
            t_leaves = _leaves(head_init(gen, head, torch.device("cpu")))
            p_leaves = _leaves(outs[name])
            # stacking adds one leading axis to every leaf
            if t_leaves and [x.dim() for x in p_leaves] == [x.dim() for x in t_leaves]:
                outs[name] = _broadcast(outs[name], n)
        self.params = {**self.params, "outputs": outs}

    @classmethod
    def from_members(cls, members: list[tuple], fused: bool = False, **calc_kwargs) -> "EnsembleCalculator":
        """``members``: ``(params, cfg[, aux])`` tuples of one architecture;
        the first member's config and aux serve."""
        params = stack_params([m[0] for m in members])
        aux = members[0][2] if len(members[0]) > 2 else {"sae": {}}
        return cls((params, members[0][1], aux), fused=fused, **calc_kwargs)

    @classmethod
    def from_registry(cls, name: str, fused: bool = False, **calc_kwargs) -> "EnsembleCalculator":
        """Every member of a registry family in one calculator
        (``from_registry("aimnet2")`` loads ``aimnet2-wb97m-d3_{0..3}``).
        The members must share one architecture.  Their float64 SAE tables
        are averaged for the host's shift: exact for the mean energy (the
        mean is linear); ``energy_std`` is the networks' spread."""
        from aimnetcentral_tpu_torch.calculators.registry import ensemble_members, registry_family, resolve_model
        from aimnetcentral_tpu_torch.models.loader import load_model

        names = ensemble_members(name)
        loaded = [load_model(resolve_model(n), registry_family=registry_family(n)) for n in names]
        cfg = loaded[0].cfg
        for ld, n in zip(loaded[1:], names[1:]):
            if ld.cfg != cfg:
                raise ValueError(
                    f"ensemble member {n!r} has a different architecture than {names[0]!r}; "
                    "load members individually instead"
                )
        params = stack_params([ld.params for ld in loaded])
        aux = dict(loaded[0].aux)
        tables = [ld.aux.get("sae", {}) for ld in loaded]
        if any(tables):
            aux["sae"] = {k: np.mean([t[k] for t in tables], axis=0) for k in tables[0]}
        return cls((params, cfg, aux), fused=fused, **calc_kwargs)

    def _get_fn(self, cfg: AIMNet2Config, forces: bool, stress: bool, hessian: bool):
        if self._fused and not (stress or hessian):
            return self._fused_fn(cfg, forces)
        mm_prec, conv_prec = precision_tiers(self.precision)
        single = derivatives.make_eval_fn(cfg, forces=forces, stress=stress, hessian=hessian, sae_external=True,
                                          matmul_precision=mm_prec, conv_precision=conv_prec)

        def ens_fn(params: dict, system: System) -> dict:
            # the mean is linear: the members' mean forces, stress and
            # Hessian are the ensemble's
            n_e = params["afv"]["weight"].shape[0]
            outs = [single(member_params(params, e), system) for e in range(n_e)]
            res = {k: torch.stack([o[k] for o in outs]).mean(0) for k in outs[0] if k != "mol_element_counts"}
            res["energy_std"] = _std(torch.stack([o["energy"] for o in outs]))
            for k in ("forces", "charges"):
                if k in outs[0]:
                    res[f"{k}_std"] = _std(torch.stack([o[k] for o in outs]))
            if "mol_element_counts" in outs[0]:
                res["mol_element_counts"] = outs[0]["mol_element_counts"]
            return res

        return ens_fn

    def _fused_fn(self, cfg: AIMNet2Config, forces: bool):
        mm_prec, conv_prec = precision_tiers(self.precision)

        def collect(data: dict) -> dict:
            out = {"energy": data["energy"].mean(0).detach(), "energy_std": _std(data["energy"]).detach()}
            for k in _KEEP:
                if data.get(k) is not None:
                    out[k] = data[k].mean(0).detach()
            out["charges_std"] = _std(data["charges"]).detach()
            if "mol_element_counts" in data:
                out["mol_element_counts"] = data["mol_element_counts"]
            return out

        def fused_fn(params: dict, system: System) -> dict:
            with ambient_matmul_context(mm_prec):
                return fused_inner(params, system)

        def fused_inner(params: dict, system: System) -> dict:
            if not forces:
                with torch.no_grad():
                    return collect(aimnet2_apply_ensemble(params, cfg, system, sae_external=True,
                                                          conv_precision=conv_prec))
            coord = system.coord.detach().requires_grad_(True)
            data = aimnet2_apply_ensemble(params, cfg, system.replace(coord=coord), sae_external=True,
                                          conv_precision=conv_prec)
            (g,) = torch.autograd.grad(data["energy"].mean(0).sum(), coord)
            out = collect(data)
            out["forces"] = torch.where((system.numbers > 0)[:, None], -g, 0.0)
            return out

        return fused_fn

    def _postprocess(self, out, system: System) -> dict[str, np.ndarray]:
        res = super()._postprocess(out, system)
        if "energy_std" in out:
            res["energy_std"] = out["energy_std"].cpu().numpy()
        valid = system.numbers.cpu().numpy() > 0
        for k in ("forces_std", "charges_std"):
            if k in out:
                res[k] = self._slots_to_compact(out[k].cpu().numpy(), valid)
        return res
