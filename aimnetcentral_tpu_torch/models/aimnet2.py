"""The AIMNet2 network (counterpart of aimnetcentral_tpu/models/aimnet2.py).

Element embedding -> shifted-Gaussian scalar+vector AEV -> message passes
(pass 0 predicts charges, middle passes update charges and features by
deltas, the last emits the ``aim`` vector) -> output heads.  NSE charge
equilibration enforces the exact total charge every pass.

Only the binned (stencil) layout is ported; there the ConvSV contraction is
kernels/conv_pass.py, which runs the CUDA kernels for CUDA tensors and the
plain versions for CPU tensors (the analogue of ``_resolve_conv_engine``).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from aimnetcentral_tpu_torch.device import resolve_device
from aimnetcentral_tpu_torch.kernels.conv_pass import conv_pass
from aimnetcentral_tpu_torch.models.heads import HeadSpec, head_apply, head_init
from aimnetcentral_tpu_torch.models.modules import MLPSpec, mlp_apply, mlp_init
from aimnetcentral_tpu_torch.ops.math import nse
from aimnetcentral_tpu_torch.ops.nb import mask_pad_atoms, mol_sum
from aimnetcentral_tpu_torch.system import System


@dataclasses.dataclass(frozen=True)
class AEVConfig:
    rmin: float = 0.8
    rc_s: float = 5.0
    nshifts_s: int = 16
    eta_s: float | None = None

    @property
    def eta(self) -> float:
        if self.eta_s is not None:
            return self.eta_s
        return (1.0 / ((self.rc_s - self.rmin) / self.nshifts_s)) ** 2

    def shifts(self) -> np.ndarray:
        return np.linspace(self.rmin, self.rc_s, self.nshifts_s + 1, dtype=np.float32)[: self.nshifts_s]


@dataclasses.dataclass(frozen=True)
class AIMNet2Config:
    aev: AEVConfig = AEVConfig()
    nfeature: int = 16
    d2features: bool = True
    ncomb_v: int = 12
    hidden: tuple[tuple[int, ...], ...] = ((512, 380), (512, 380), (512, 380, 380))
    aim_size: int = 256
    num_charge_channels: int = 1
    outputs: tuple[tuple[str, HeadSpec], ...] = ()

    @property
    def nshifts(self) -> int:
        return self.aev.nshifts_s

    @property
    def nfeature_tot(self) -> int:
        return self.nfeature * self.nshifts if self.d2features else self.nfeature

    def conv_a_size(self) -> int:
        return self.nfeature * self.nshifts + self.nfeature * self.ncomb_v

    def conv_q_size(self) -> int:
        c = self.num_charge_channels
        return c * self.nshifts + c * self.ncomb_v


def _init_agh(rng: np.random.Generator, nchannel: int, m: int, n: int) -> np.ndarray:
    """Maxmin-orthogonal init of the vector-combination tensor (numpy)."""
    out = np.zeros((nchannel, m, n), dtype=np.float32)
    x = np.arange(m)[None, :]
    for c in range(nchannel):
        coeff = rng.standard_normal((8 * n, 4))[:, None, :]
        a1, a2, a3, a4 = coeff[..., 0], coeff[..., 1], coeff[..., 2], coeff[..., 3]
        y = a1 * np.sin(a2 * 2 * x * math.pi / m) + a3 * np.cos(a4 * 2 * x * math.pi / m)
        y = y - y.mean(-1, keepdims=True)
        y = y / y.std(-1, keepdims=True)
        dmat = np.linalg.norm(y[:, None, :] - y[None, :, :], axis=-1)
        ret = np.zeros((n, m))
        mask = np.ones(y.shape[0], dtype=bool)
        i = int(dmat.sum(-1).argmax())
        ret[0] = y[i]
        mask[i] = False
        for j in range(1, n):
            d = np.linalg.norm(ret[:j, None, :] - y[None, :, :], axis=-1).min(axis=0)
            order = np.argsort(d)
            maxidx = int(order[mask[order]][-1])
            ret[j] = y[maxidx]
            mask[maxidx] = False
        out[c] = ret.T
    return out


def mlp_spec_for_pass(cfg: AIMNet2Config, ipass: int) -> MLPSpec:
    return MLPSpec(hidden=cfg.hidden[ipass], last_linear=ipass == 0)


def aimnet2_init(cfg: AIMNet2Config, seed: int = 0, device: str | torch.device = "cuda") -> dict:
    """Randomly initialized parameters (the JAX package's init scheme, drawn
    from a ``torch.Generator``; ``agh`` from numpy as there).  The numbers
    differ from the JAX package's for the same seed: to compare the two,
    carry JAX parameters across with models/bridge.py."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    nprng = np.random.default_rng(seed)

    afv = torch.empty((64, cfg.nfeature), device=dev)
    torch.nn.init.orthogonal_(afv, generator=gen)
    afv[0] = 0.0
    if cfg.d2features:
        afv = afv[:, :, None].expand(64, cfg.nfeature, cfg.nshifts).reshape(64, cfg.nfeature_tot)

    def t(x: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(x, device=dev)

    params: dict = {
        "afv": {"weight": afv.contiguous()},
        "aev": {
            "rc_s": torch.tensor(cfg.aev.rc_s, dtype=torch.float32, device=dev),
            "eta_s": torch.tensor(cfg.aev.eta, dtype=torch.float32, device=dev),
            "shifts_s": t(cfg.aev.shifts()),
        },
        "conv_a": {"agh": t(_init_agh(nprng, cfg.nfeature, cfg.nshifts, cfg.ncomb_v))},
        "conv_q": {"agh": t(_init_agh(nprng, cfg.num_charge_channels, cfg.nshifts, cfg.ncomb_v))},
    }
    c = cfg.num_charge_channels
    n_in0 = cfg.conv_a_size() + cfg.nfeature_tot
    mlps = [mlp_init(gen, n_in0, cfg.nfeature_tot + 2 * c, mlp_spec_for_pass(cfg, 0), dev)]
    n_in = cfg.conv_a_size() + cfg.conv_q_size() + cfg.nfeature_tot + c
    for ipass in range(1, len(cfg.hidden) - 1):
        mlps.append(mlp_init(gen, n_in, cfg.nfeature_tot + 2 * c, mlp_spec_for_pass(cfg, ipass), dev))
    mlps.append(mlp_init(gen, n_in, cfg.aim_size, mlp_spec_for_pass(cfg, len(cfg.hidden) - 1), dev))
    params["mlps"] = mlps
    params["outputs"] = {name: head_init(gen, head, dev) for name, head in cfg.outputs}
    return params


def aimnet2_apply(params: dict, cfg: AIMNet2Config, system: System, sae_external: bool = False) -> dict:
    """Full forward pass on a binned System.  Returns the data dict with
    ``energy`` (num_mol,) [without SAE when ``sae_external``], ``charges``
    (N,), ``aim`` (N, aim_size), ``_delta_Q`` and, when SAE is external,
    ``mol_element_counts``."""
    if system.bins is None:
        raise NotImplementedError(
            "the indexed (non-binned) layout is not ported yet (ROADMAP.md, "
            "queue 1: the indexed / gas-phase path)"
        )
    if not cfg.d2features:
        raise NotImplementedError("the stencil conv kernels take d2features models only")
    n = system.natoms
    c = cfg.num_charge_channels
    a = params["afv"]["weight"][system.numbers].reshape(n, cfg.nfeature, cfg.nshifts)

    if c == 2:
        if system.mult is None:
            raise ValueError("mult is required for NSE (two charge channel) models")
        half_spin = 0.5 * (system.mult - 1.0)
        half_q = 0.5 * system.charge
        big_q = torch.stack([half_q + half_spin, half_q - half_spin], dim=-1)
    else:
        big_q = system.charge[:, None]

    data: dict = {"_sae_external": sae_external}
    charges = None
    delta_q_log = []
    npass = len(cfg.hidden)
    a_flat = a.reshape(n, -1)
    for ipass in range(npass):
        conv_a, conv_q = conv_pass(
            system,
            params["aev"],
            a,
            charges if ipass > 0 else None,
            params["conv_a"]["agh"],
            params["conv_q"]["agh"],
            rc_static=cfg.aev.rc_s,
        )
        if ipass == 0:
            x = torch.cat([a_flat, conv_a], dim=-1)
        else:
            x = torch.cat([a_flat, conv_a, charges, conv_q], dim=-1)
        out = mlp_apply(params["mlps"][ipass], x, mlp_spec_for_pass(cfg, ipass))
        out = mask_pad_atoms(out, system.numbers)
        if ipass == npass - 1:
            data["aim"] = out
        else:
            _q, _f, delta_a = out[..., :c], out[..., c : 2 * c], out[..., 2 * c :]
            delta_q_log.append(big_q - mol_sum(_q, system.mol_idx, system.num_mol))
            q = _q if ipass == 0 else charges + _q
            q, _dq = nse(big_q, q, _f * _f, system.mol_idx, system.num_mol)
            charges = q
            a = a + delta_a.reshape(a.shape)
            a_flat = a.reshape(n, -1)

    if c == 2:
        data["spin_charges"] = charges[..., 0] - charges[..., 1]
        data["charges"] = charges.sum(dim=-1)
    else:
        data["charges"] = charges.squeeze(-1)
    data["_delta_Q"] = torch.stack(delta_q_log, dim=0) if delta_q_log else None

    for name, head in cfg.outputs:
        data = head_apply(head, params["outputs"][name], data, system)
    return data
