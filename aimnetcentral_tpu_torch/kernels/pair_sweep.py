"""The half-stencil pair sweep and its adjoint: CUDA kernels, plain versions
and the pair terms they specialise.

Replaces the two Pallas TPU kernels of aimnetcentral_tpu/kernels/pair_sweep.py:

- ``pair_sweep_forward`` (kernel D, csrc/pair_fwd.cu) replaces
  ``_fwd_kernel_hb`` (pair_sweep.py:228) and ``_hb_gather``: the per-atom
  sums of a symmetric pair term over every pair within a cutoff.
- ``pair_sweep_backward`` (kernel E, csrc/pair_bwd.cu plus one fixed-order
  sum) replaces ``_bwd_kernel_hb`` (pair_sweep.py:283) and
  ``_pair_acc_hb_bwd``: given the cotangent of the sums, the adjoints of
  the coordinates, of the per-atom extras and of the lattice shifts (which
  carry the stress).

The operands describe the half stencil (each unordered pair once, its value
sent to both ends), and the plain versions sweep it so.  The kernels walk
it as the full stencil from the receiver's side, one warp per receiver
atom, and contract only the real pairs within the cutoff, which a ballot
over the candidate slots picks out (csrc/pair_walk.cuh): every output is
the receiver's own row, with no float atomics and no candidate-side rows.

The JAX package traces any pair function into its kernel; a CUDA kernel has
one specialisation per term.  Every term here has the form

    e_ij = c_ij g(d_ij, s_i, s_j),   c_ij = p_i . r_j  (bilinear terms) or 1,

with NS scalar extras ``s`` per atom (one for most terms) and, for a
bilinear term, two per-atom vectors ``p`` (read on the receiver) and ``r``
(read on the candidate) of width V.  The extras are packed per atom as
``[p (V), r (V), s (NS)]``, K = 2V + NS.  Terms: DSF Coulomb (s = q),
simple (unbounded) Coulomb (s = q), short-range Coulomb (s = q), the D3
coordination number (s = rcov), the D3(BJ) energy over the factorised C6
(p, r, s = r4r2), the real-space Ewald sum (s = q), GFN1 short-range
repulsion (s = alpha, zeff) and D3 with the TS combination rule over the
network's C6 and alpha (s = c6, alpha, r4r2).  Each term has its plain
``g`` (differentiated by autograd in the plain versions) and its hand
derivatives ``g_grad``, the formulas the CUDA functors
(csrc/pair_terms.cuh) compute; the tests hold the latter to autograd.  A
term of several scalars takes ``s_i`` and ``s_j`` with a trailing axis of
NS and returns its scalar derivatives with one too.

Member forms (``MemberTerm``): a fused ensemble of E members sweeps one
term with one output per member, ``e_ij,m = g(d_ij, s_i,m, s_j,m)``.  The
extras are scalars only, ``[shared (NH), member 0 (NP), ..., member E-1]``
(DSF, simple, SR Coulomb and the real-space Ewald sum: q per member; D3TS:
r4r2 shared, C6 and alpha per member), the sums and their cotangent are
(B, C, E), and the kernels compute the member-independent factor of a pair
once (the erfc kernel, the damping) and each member's product from it.

Offsets: ``s = 0`` is the zero offset, where each bin meets itself in both
orderings and only the receiver side is summed; every other half offset
sends each pair's value to both ends.  The self pair is dropped only at
``s = 0``: on a grid with fewer than 2r+1 bins per axis the same bin recurs
at other offsets as a periodic image.  Non-pairs take d2 := 1 before the
sqrt, so no inf or NaN reaches a sum multiplied by 0.

Each wrapper takes its plain version only for tensors on the CPU; for CUDA
tensors it launches the kernel or raises.  ``launches`` on each wrapper
counts its kernel launches.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math
from typing import ClassVar

import torch
from torch.utils.checkpoint import checkpoint

from aimnetcentral_tpu_torch.constants import Bohr_inv
from aimnetcentral_tpu_torch.kernels.build import bind, ptr
from aimnetcentral_tpu_torch.kernels.conv_stencil import SMEM_LIMIT
from aimnetcentral_tpu_torch.ops.math import erfc_approx

WARPS = 4  # receiver rows a block of kernels D and E, one warp each
QUEUE = 64  # a warp's queue of pairs (csrc/pair_walk.cuh::kQueue)
MAX_V = 96  # vector columns of the extras kernel E holds in a warp's registers
MAX_MEMBERS = 8  # outputs of a member form: accumulators a lane (csrc/pair_terms.cuh::kMaxMembers)
N_CONSTS = 8  # the cutoff plus a term's constants, passed by value

# Abramowitz & Stegun 7.1.26, the coefficients of ops/math.py::erfc_approx
_AS_P = 0.3275911
_AS_A = (0.254829592, -0.284496736, 1.421413741, -1.453152027, 1.061405429)
_INV_E = 0.36787944117144233
_XMAX = 1.0 - 1e-6  # the exp envelope's clamp


# ---------------------------------------------------------------------------
# pair terms


def erfc_approx_grad(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``(erfc_approx(x), d/dx erfc_approx(x))``: the derivative of the
    rational form itself, not of the exact erfc."""
    a1, a2, a3, a4, a5 = _AS_A
    t = 1.0 / (1.0 + _AS_P * x)
    q = a1 + t * (a2 + t * (a3 + t * (a4 + t * a5)))
    dq = a2 + t * (2.0 * a3 + t * (3.0 * a4 + t * 4.0 * a5))
    ex = torch.exp(-x * x)
    f = t * q * ex
    dt = -_AS_P * t * t
    return f, (q + t * dq) * dt * ex - 2.0 * x * f


def _inside(x: torch.Tensor, lo: float, hi: float | None = None) -> torch.Tensor:
    """Where ``torch.clamp`` passes the gradient: lo <= x <= hi."""
    ok = x >= lo
    return ok if hi is None else ok & (x <= hi)


def _envelope(d, rc: float, envelope: str):
    """The SR envelope fc(d) of the Coulomb heads: the exp mollifier (zero
    from rc on, through its clamp) or the cosine cutoff (zero from rc on)."""
    if envelope == "exp":
        x = torch.clamp(d / rc, 0.0, _XMAX)
        return torch.exp(-1.0 / (1.0 - x * x)) / _INV_E
    fc = 0.5 * (torch.cos(torch.clamp(d, 1e-6, rc) * (math.pi / rc)) + 1.0)
    return torch.where(d < rc, fc, 0.0)


def _envelope_grad(d, rc: float, envelope: str):
    """``(fc(d), dfc/dd)`` of :func:`_envelope`, zero where its clamps stop
    the gradient."""
    if envelope == "exp":
        xr = d / rc
        x = torch.clamp(xr, 0.0, _XMAX)
        den = 1.0 - x * x
        fc = torch.exp(-1.0 / den) / _INV_E
        return fc, torch.where(_inside(xr, 0.0, _XMAX), fc * (-2.0 * x / (den * den)) / rc, 0.0)
    arg = torch.clamp(d, 1e-6, rc) * (math.pi / rc)
    inside = d < rc
    fc = torch.where(inside, 0.5 * (torch.cos(arg) + 1.0), 0.0)
    dfc = torch.where(inside & _inside(d, 1e-6, rc), -0.5 * torch.sin(arg) * (math.pi / rc), 0.0)
    return fc, dfc


def _envelope_code(envelope: str, subtract_sr: bool) -> float:
    """The envelope as the CUDA functors read it: 0 none, 1 exp, 2 cosine."""
    return 0.0 if not subtract_sr else (1.0 if envelope == "exp" else 2.0)


@dataclasses.dataclass(frozen=True)
class DSFTerm:
    """Damped-shifted-force Coulomb, ``q_i q_j h(d)`` with
    ``h = erfc(a d)/d - erfc(a rc)/rc + (d - rc) slope``, minus the SR
    envelope part ``fc(d)/d`` when ``subtract_sr`` (exact on this stencil:
    the envelope is zero beyond rc << dsf_rc)."""

    alpha: float
    dsf_rc: float
    rc: float
    envelope: str = "exp"
    subtract_sr: bool = True
    name: ClassVar[str] = "dsf"
    code: ClassVar[int] = 0
    vector_keys: ClassVar[tuple[str, ...]] = ()
    scalar_key: ClassVar[str] = "q"
    scalar_keys: ClassVar[tuple[str, ...]] = ("q",)

    @property
    def shift_val(self) -> float:
        return math.erfc(self.alpha * self.dsf_rc) / self.dsf_rc

    @property
    def shift_slope(self) -> float:
        a, rc = self.alpha, self.dsf_rc
        return math.erfc(a * rc) / rc**2 + 2.0 * a / math.sqrt(math.pi) * math.exp(-((a * rc) ** 2)) / rc

    def consts(self) -> tuple[float, ...]:
        env = _envelope_code(self.envelope, self.subtract_sr)
        return (self.alpha, self.shift_val, self.shift_slope, self.dsf_rc, self.rc, env)

    def _h(self, d):
        h = erfc_approx(self.alpha * d) / d - self.shift_val + (d - self.dsf_rc) * self.shift_slope
        if self.subtract_sr:
            h = h - _envelope(d, self.rc, self.envelope) / d
        return h

    def g(self, d, si, sj, valid):
        return si * sj * self._h(d)

    def g_grad(self, d, si, sj, valid):
        a = self.alpha
        ea, dea = erfc_approx_grad(a * d)
        h = ea / d - self.shift_val + (d - self.dsf_rc) * self.shift_slope
        dh = a * dea / d - ea / (d * d) + self.shift_slope
        if self.subtract_sr:
            fc, dfc = _envelope_grad(d, self.rc, self.envelope)
            h = h - fc / d
            dh = dh - (dfc / d - fc / (d * d))
        return si * sj * h, si * sj * dh, sj * h, si * h


@dataclasses.dataclass(frozen=True)
class CoulombSimpleTerm:
    """Unbounded Coulomb, ``q_i q_j (1/d - fc(d)/d)``, the SR envelope part
    subtracted when ``subtract_sr`` (engine_binned.coulomb_simple_binned in
    the JAX package).  Swept at cutoff inf on the molecule-bin layout, where
    the radius-0 sweep meets every pair of a molecule."""

    rc: float
    envelope: str = "exp"
    subtract_sr: bool = True
    name: ClassVar[str] = "coulomb_simple"
    code: ClassVar[int] = 3
    vector_keys: ClassVar[tuple[str, ...]] = ()
    scalar_key: ClassVar[str] = "q"
    scalar_keys: ClassVar[tuple[str, ...]] = ("q",)

    def consts(self) -> tuple[float, ...]:
        return (self.rc, _envelope_code(self.envelope, self.subtract_sr))

    def g(self, d, si, sj, valid):
        h = 1.0 / d
        if self.subtract_sr:
            h = h - _envelope(d, self.rc, self.envelope) / d
        return si * sj * h

    def g_grad(self, d, si, sj, valid):
        h, dh = 1.0 / d, -1.0 / (d * d)
        if self.subtract_sr:
            fc, dfc = _envelope_grad(d, self.rc, self.envelope)
            h = h - fc / d
            dh = dh - (dfc / d - fc / (d * d))
        return si * sj * h, si * sj * dh, sj * h, si * h


@dataclasses.dataclass(frozen=True)
class CoulombSRTerm:
    """Short-range Coulomb, ``q_i q_j fc(d)/d`` with the SR envelope, swept
    at cutoff ``rc`` (engine_binned.coulomb_sr_binned in the JAX package):
    the SRCoulomb head of v2 artifacts, which the head subtracts.  Kernels
    D and E evaluate the term in double from their float distance
    (csrc/pair_terms.cuh::CoulombSRTerm); the plain versions in the
    inputs' type."""

    rc: float
    envelope: str = "exp"
    name: ClassVar[str] = "coulomb_sr"
    code: ClassVar[int] = 4
    vector_keys: ClassVar[tuple[str, ...]] = ()
    scalar_key: ClassVar[str] = "q"
    scalar_keys: ClassVar[tuple[str, ...]] = ("q",)

    def consts(self) -> tuple[float, ...]:
        return (self.rc, _envelope_code(self.envelope, True))

    def g(self, d, si, sj, valid):
        return si * sj * _envelope(d, self.rc, self.envelope) / d

    def g_grad(self, d, si, sj, valid):
        fc, dfc = _envelope_grad(d, self.rc, self.envelope)
        h, dh = fc / d, dfc / d - fc / (d * d)
        return si * sj * h, si * sj * dh, sj * h, si * h


@dataclasses.dataclass(frozen=True)
class D3CNTerm:
    """D3 coordination number, ``sigmoid(16 ((rcov_i + rcov_j) / d - 1))``
    with d in Bohr (engine_binned.d3_cn_fn in the JAX package)."""

    name: ClassVar[str] = "d3_cn"
    code: ClassVar[int] = 1
    vector_keys: ClassVar[tuple[str, ...]] = ()
    scalar_key: ClassVar[str] = "rcov"
    scalar_keys: ClassVar[tuple[str, ...]] = ("rcov",)

    def consts(self) -> tuple[float, ...]:
        return (Bohr_inv,)

    def g(self, d, si, sj, valid):
        db = torch.clamp(d * Bohr_inv, min=1e-12)
        return torch.sigmoid(16.0 * ((si + sj) / db - 1.0))

    def g_grad(self, d, si, sj, valid):
        dr = d * Bohr_inv
        db = torch.clamp(dr, min=1e-12)
        rsum = si + sj
        sg = torch.sigmoid(16.0 * (rsum / db - 1.0))
        k = sg * (1.0 - sg) * 16.0
        dd = torch.where(_inside(dr, 1e-12), -k * rsum / (db * db) * Bohr_inv, 0.0)
        ds = k / db
        return sg, dd, ds, ds


def _bj_damping_grad(db, rr, r0, a1: float, s6: float, s8: float):
    """Becke-Johnson damping ``s6/(d^6 + r0^6) + s8 rr/(d^8 + r0^8)`` with
    ``r0 = a1 sqrt(rr) + a2`` (d in Bohr), and its derivatives in d and rr."""
    d2 = db * db
    d6 = d2 * d2 * d2
    d8 = d6 * d2
    r0_2 = r0 * r0
    r0_6 = r0_2 * r0_2 * r0_2
    r0_8 = r0_6 * r0_2
    den6 = d6 + r0_6
    den8 = d8 + r0_8
    damping = s6 / den6 + s8 * rr / den8
    ddamp_db = -6.0 * s6 * (d6 / db) / (den6 * den6) - 8.0 * s8 * rr * (d8 / db) / (den8 * den8)
    dr0 = a1 / (2.0 * torch.sqrt(rr))
    ddamp_drr = (
        -6.0 * s6 * (r0_6 / r0) * dr0 / (den6 * den6)
        + s8 / den8
        - 8.0 * s8 * rr * (r0_8 / r0) * dr0 / (den8 * den8)
    )
    return damping, ddamp_db, ddamp_drr


@dataclasses.dataclass(frozen=True)
class D3EnergyTerm:
    """D3(BJ) energy over the factorised C6 (engine_binned.d3_e_fn in the
    JAX package): ``e = -(p_i . r_j) damping(d, rr) switch(d)`` with
    ``rr = 3 r4r2_i r4r2_j``, Becke-Johnson damping and the S5 switch from
    ``r_on`` to ``r_off`` (Angstrom).  Non-pairs take rr := 1 (r4r2 of the
    padding atom is 0, and sqrt has no finite slope there)."""

    a1: float
    a2: float
    s8: float
    s6: float = 1.0
    r_on: float = 12.0
    r_off: float = 15.0
    name: ClassVar[str] = "d3_energy"
    code: ClassVar[int] = 2
    vector_keys: ClassVar[tuple[str, ...]] = ("p", "r")
    scalar_key: ClassVar[str] = "rr"
    scalar_keys: ClassVar[tuple[str, ...]] = ("rr",)

    def consts(self) -> tuple[float, ...]:
        return (self.a1, self.a2, self.s8, self.s6, self.r_on * Bohr_inv, self.r_off * Bohr_inv, Bohr_inv)

    def _parts(self, d, si, sj, valid):
        db = torch.clamp(d * Bohr_inv, min=1e-12)
        rr = torch.where(valid, 3.0 * si * sj, 1.0)
        r0 = self.a1 * torch.sqrt(rr) + self.a2
        return db, rr, r0

    def g(self, d, si, sj, valid):
        db, rr, r0 = self._parts(d, si, sj, valid)
        d2 = db * db
        d6 = d2 * d2 * d2
        d8 = d6 * d2
        r0_2 = r0 * r0
        r0_6 = r0_2 * r0_2 * r0_2
        r0_8 = r0_6 * r0_2
        damping = self.s6 / (d6 + r0_6) + self.s8 * rr / (d8 + r0_8)
        from aimnetcentral_tpu_torch.models.lr import _s5_switch  # models imports this module

        return -damping * _s5_switch(db, self.r_on * Bohr_inv, self.r_off * Bohr_inv)

    def g_grad(self, d, si, sj, valid):
        dr = d * Bohr_inv
        db, rr, r0 = self._parts(d, si, sj, valid)
        damping, ddamp_db, ddamp_drr = _bj_damping_grad(db, rr, r0, self.a1, self.s6, self.s8)
        r_on, r_off = self.r_on * Bohr_inv, self.r_off * Bohr_inv
        if r_off <= r_on:
            sw, dsw = torch.ones_like(db), torch.zeros_like(db)
        else:
            tr = (db - r_on) / (r_off - r_on)
            t = torch.clamp(tr, 0.0, 1.0)
            on = db <= r_on
            sw = torch.where(on, 1.0, 1.0 - (10.0 * t**3 - 15.0 * t**4 + 6.0 * t**5))
            dsw = torch.where(
                on | ~_inside(tr, 0.0, 1.0),
                0.0,
                -(30.0 * t**2 - 60.0 * t**3 + 30.0 * t**4) / (r_off - r_on),
            )
        dd = torch.where(_inside(dr, 1e-12), -(ddamp_db * sw + damping * dsw) * Bohr_inv, 0.0)
        drr = torch.where(valid, -sw * ddamp_drr * 3.0, 0.0)
        return -damping * sw, dd, drr * sj, drr * si


@dataclasses.dataclass(frozen=True)
class EwaldRealTerm:
    """The real-space Ewald sum, ``q_i q_j erfc(d / (sqrt(2) eta)) / d``
    within the real-space cutoff, with the rational ``erfc_approx``
    (engine_binned.ewald_real_binned in the JAX package), minus the SR
    envelope part ``fc(d)/d`` when ``subtract_sr``: the head's
    ``coulomb_sr_binned``, which JAX sweeps apart, in the same sweep (exact:
    the envelope is zero beyond rc, below the real-space cutoff), as DSF
    does.  ``eta`` is a constant of the launch, so a new cell's eta needs
    no rebuild."""

    eta: float
    rc: float = 4.6
    envelope: str = "exp"
    subtract_sr: bool = False
    name: ClassVar[str] = "ewald_real"
    code: ClassVar[int] = 5
    vector_keys: ClassVar[tuple[str, ...]] = ()
    scalar_key: ClassVar[str] = "q"
    scalar_keys: ClassVar[tuple[str, ...]] = ("q",)

    @property
    def inv_width(self) -> float:
        """1 / (sqrt(2) eta): erfc's argument is d times this."""
        return 1.0 / (math.sqrt(2.0) * self.eta)

    def consts(self) -> tuple[float, ...]:
        return (self.inv_width, self.rc, _envelope_code(self.envelope, self.subtract_sr))

    def g(self, d, si, sj, valid):
        h = erfc_approx(d * self.inv_width) / d
        if self.subtract_sr:
            h = h - _envelope(d, self.rc, self.envelope) / d
        return si * sj * h

    def g_grad(self, d, si, sj, valid):
        c = self.inv_width
        ea, dea = erfc_approx_grad(d * c)
        h, dh = ea / d, c * dea / d - ea / (d * d)
        if self.subtract_sr:
            fc, dfc = _envelope_grad(d, self.rc, self.envelope)
            h = h - fc / d
            dh = dh - (dfc / d - fc / (d * d))
        return si * sj * h, si * sj * dh, sj * h, si * h


_CUTOFF_FN_CODES = {"none": 0.0, "exp_cutoff": 1.0, "cosine_cutoff": 2.0}


@dataclasses.dataclass(frozen=True)
class SRRepTerm:
    """GFN1 short-range repulsion, ``exp(-a_i a_j d^1.5) z_i z_j / d``
    times the optional exp or cosine cutoff at ``rc`` (engine_binned.
    srrep_binned in the JAX package), swept at ``rc`` on the SR layout.
    Two scalars an atom: s = (alpha, zeff)."""

    rc: float
    cutoff_fn: str = "none"
    name: ClassVar[str] = "srrep"
    code: ClassVar[int] = 6
    vector_keys: ClassVar[tuple[str, ...]] = ()
    scalar_keys: ClassVar[tuple[str, ...]] = ("alpha", "zeff")

    def __post_init__(self):
        if self.cutoff_fn not in _CUTOFF_FN_CODES:
            raise ValueError(f"unknown cutoff_fn {self.cutoff_fn!r}")

    def consts(self) -> tuple[float, ...]:
        return (self.rc, _CUTOFF_FN_CODES[self.cutoff_fn])

    def _fc(self, d):
        if self.cutoff_fn == "none":
            return torch.ones_like(d), torch.zeros_like(d)
        return _envelope_grad(d, self.rc, "exp" if self.cutoff_fn == "exp_cutoff" else "cosine")

    def g(self, d, si, sj, valid):
        e = torch.exp(-si[..., 0] * sj[..., 0] * d**1.5) * si[..., 1] * sj[..., 1] / d
        if self.cutoff_fn == "none":
            return e
        return e * _envelope(d, self.rc, "exp" if self.cutoff_fn == "exp_cutoff" else "cosine")

    def g_grad(self, d, si, sj, valid):
        a, z = si[..., 0] * sj[..., 0], si[..., 1] * sj[..., 1]
        sq = torch.sqrt(d)
        ex = torch.exp(-a * d * sq)
        fc, dfc = self._fc(d)
        h = ex * fc / d  # g / z
        dh = ex * (-1.5 * a * sq * fc / d + dfc / d - fc / (d * d))
        g = z * h
        gsi = torch.stack([-sj[..., 0] * d * sq * g, sj[..., 1] * h], dim=-1)
        gsj = torch.stack([-si[..., 0] * d * sq * g, si[..., 1] * h], dim=-1)
        return g, z * dh, gsi, gsj


@dataclasses.dataclass(frozen=True)
class D3TSTerm:
    """D3-like dispersion with the TS combination rule (engine_binned.
    d3ts_binned in the JAX package): ``e = -c6_ij damping(d, rr)`` with
    ``c6_ij = 2 c6_i c6_j / max(c6_i a_j/a_i + c6_j a_i/a_j, 1e-4)``,
    ``rr = 3 r4r2_i r4r2_j`` and Becke-Johnson damping, no switch.  Three
    scalars an atom: s = (c6, alpha, r4r2); c6 and alpha come out of the
    network (DispParam), so the kernels return the adjoint of each.
    Non-pairs take rr := 1, as in JAX."""

    a1: float
    a2: float
    s8: float
    s6: float = 1.0
    name: ClassVar[str] = "d3ts"
    code: ClassVar[int] = 7
    vector_keys: ClassVar[tuple[str, ...]] = ()
    scalar_keys: ClassVar[tuple[str, ...]] = ("c6", "alpha", "rr")

    def consts(self) -> tuple[float, ...]:
        return (self.a1, self.a2, self.s8, self.s6, Bohr_inv)

    def _c6(self, si, sj):
        c6i, ai, c6j, aj = si[..., 0], si[..., 1], sj[..., 0], sj[..., 1]
        den = c6i * aj / ai + c6j * ai / aj
        return c6i, ai, c6j, aj, den, torch.clamp(den, min=1e-4)

    def g(self, d, si, sj, valid):
        c6i, _ai, c6j, _aj, _den, cl = self._c6(si, sj)
        rr = torch.where(valid, 3.0 * si[..., 2] * sj[..., 2], 1.0)
        r0 = self.a1 * torch.sqrt(rr) + self.a2
        db = d * Bohr_inv
        return -(2.0 * c6i * c6j / cl) * (self.s6 / (db**6 + r0**6) + self.s8 * rr / (db**8 + r0**8))

    def g_grad(self, d, si, sj, valid):
        c6i, ai, c6j, aj, den, cl = self._c6(si, sj)
        on = _inside(den, 1e-4)  # where the clamp passes the gradient
        c6ij = 2.0 * c6i * c6j / cl
        rr = torch.where(valid, 3.0 * si[..., 2] * sj[..., 2], 1.0)
        r0 = self.a1 * torch.sqrt(rr) + self.a2
        damping, ddamp_db, ddamp_drr = _bj_damping_grad(d * Bohr_inv, rr, r0, self.a1, self.s6, self.s8)
        k = c6ij / cl  # -dc6ij/dcl
        dcl_dc6i = torch.where(on, aj / ai, 0.0)
        dcl_dai = torch.where(on, -c6i * aj / (ai * ai) + c6j / aj, 0.0)
        dcl_dc6j = torch.where(on, ai / aj, 0.0)
        dcl_daj = torch.where(on, c6i / ai - c6j * ai / (aj * aj), 0.0)
        drr = torch.where(valid, -c6ij * ddamp_drr * 3.0, 0.0)
        gsi = torch.stack(
            [-damping * (2.0 * c6j / cl - k * dcl_dc6i), damping * k * dcl_dai, drr * sj[..., 2]], dim=-1
        )
        gsj = torch.stack(
            [-damping * (2.0 * c6i / cl - k * dcl_dc6j), damping * k * dcl_daj, drr * si[..., 2]], dim=-1
        )
        return -c6ij * damping, -c6ij * ddamp_db * Bohr_inv, gsi, gsj


_MEMBER_KEYS = {  # (shared, per member) scalars of the member forms
    "dsf": ((), ("q",)),
    "coulomb_simple": ((), ("q",)),
    "coulomb_sr": ((), ("q",)),
    "ewald_real": ((), ("q",)),
    "d3ts": (("rr",), ("c6", "alpha")),
}


@dataclasses.dataclass(frozen=True)
class MemberTerm:
    """The member form of ``term`` for ``n`` ensemble members: one output
    per member, ``g_m = term.g(d, s_i,m, s_j,m)`` with each member's
    scalars (csrc/pair_terms.cuh's member functors).  The packed scalars
    are ``[shared, member 0, ..., member n-1]``; ``g`` and ``g_grad`` take
    them and return a trailing member axis."""

    term: "DSFTerm | CoulombSimpleTerm | CoulombSRTerm | EwaldRealTerm | D3TSTerm"
    n: int
    vector_keys: ClassVar[tuple[str, ...]] = ()

    def __post_init__(self):
        if self.term.name not in _MEMBER_KEYS:
            raise ValueError(f"the {self.term.name} term has no member form")
        if not 1 <= self.n <= MAX_MEMBERS:
            raise ValueError(f"pair kernels take 1 to {MAX_MEMBERS} members, not {self.n}")

    @property
    def name(self) -> str:
        return f"{self.term.name}_multi"

    @property
    def code(self) -> int:
        return self.term.code

    @property
    def shared_keys(self) -> tuple[str, ...]:
        return _MEMBER_KEYS[self.term.name][0]

    @property
    def member_keys(self) -> tuple[str, ...]:
        return _MEMBER_KEYS[self.term.name][1]

    @property
    def scalar_keys(self) -> tuple[str, ...]:
        """One name per packed scalar (K of them)."""
        return self.shared_keys + self.member_keys * self.n

    def consts(self) -> tuple[float, ...]:
        return self.term.consts()

    def _split(self, s):
        """Packed scalars (..., K) -> each member's as the single term takes
        them, (..., n) for one scalar, else (..., n, NS) in the term's
        order (D3TS: c6, alpha, rr)."""
        nh, npm = len(self.shared_keys), len(self.member_keys)
        m = s[..., nh:].reshape(s.shape[:-1] + (self.n, npm))
        if nh:
            m = torch.cat([m, s[..., None, :nh].expand(s.shape[:-1] + (self.n, nh))], dim=-1)
        return m[..., 0] if m.shape[-1] == 1 else m

    def g(self, d, si, sj, valid):
        """(..., n): each member's value."""
        return self.term.g(d[..., None], self._split(si), self._split(sj), valid[..., None])

    def g_grad(self, d, si, sj, valid):
        """``(g, dg/dd, dg/ds_i)``: (..., n), (..., n) and the receiver's
        packed scalars' derivatives of each member's value, (..., n, K)
        (zero off the member's own scalars and the shared ones)."""
        g, gd, gsi, _gsj = self.term.g_grad(d[..., None], self._split(si), self._split(sj), valid[..., None])
        nh, npm = len(self.shared_keys), len(self.member_keys)
        if gsi.dim() == g.dim():
            gsi = gsi[..., None]
        jac = gsi.new_zeros(g.shape + (nh + self.n * npm,))
        for m in range(self.n):
            jac[..., m, nh + m * npm : nh + (m + 1) * npm] = gsi[..., m, :npm]
            jac[..., m, :nh] = gsi[..., m, npm:]
        return g, gd, jac


PairTerm = (
    DSFTerm | CoulombSimpleTerm | CoulombSRTerm | D3CNTerm | D3EnergyTerm | EwaldRealTerm | SRRepTerm | D3TSTerm
    | MemberTerm
)


def pack_extras(term: PairTerm, extras: dict[str, torch.Tensor]) -> torch.Tensor:
    """Per-atom extras as the kernels take them: (L, K) ``[p, r, s]``; a
    member form's ``[shared, member 0, ...]`` from shared (L,) and member
    (L, n) extras."""
    if isinstance(term, MemberTerm):
        shared = [extras[k][:, None] for k in term.shared_keys]
        member = torch.stack([extras[k] for k in term.member_keys], dim=-1)  # (L, n, NP)
        return torch.cat(shared + [member.reshape(member.shape[0], -1)], dim=-1)
    cols = [extras[k] for k in term.vector_keys] + [extras[k][:, None] for k in term.scalar_keys]
    return torch.cat(cols, dim=-1)


def pair_value(term: PairTerm, d, valid, ext_self, ext_cand):
    """The (B, Ci, Cj) pair values ``c_ij g(d_ij, s_i, s_j)`` for receiver
    extras (B, Ci, K) and candidate extras (B, Cj, K); (B, Ci, Cj, n) for a
    member form."""
    if isinstance(term, MemberTerm):
        return term.g(d, ext_self[:, :, None, :], ext_cand[:, None, :, :], valid)
    ns = len(term.scalar_keys)
    v = (ext_self.shape[-1] - ns) // 2
    si = ext_self[..., 2 * v :][:, :, None, :]
    sj = ext_cand[..., 2 * v :][:, None, :, :]
    if ns == 1:
        si, sj = si[..., 0], sj[..., 0]
    g = term.g(d, si, sj, valid)
    if v == 0:
        return g
    c = torch.einsum("bix,bjx->bij", ext_self[..., :v], ext_cand[..., v : 2 * v])
    return c * g


# ---------------------------------------------------------------------------
# plain versions


@dataclasses.dataclass(frozen=True)
class PairStatic:
    """Static shapes of one sweep: B bins of capacity C, S half offsets
    (the zero offset first), K = 2V + NS extras an atom (NS scalars), the
    cutoff, and the outputs a receiver of a member form (0: one sum)."""

    b_tot: int
    c: int
    s_tot: int
    k: int
    cutoff: float
    ns: int = 1
    members: int = 0

    @property
    def v(self) -> int:
        return (self.k - self.ns) // 2

    @property
    def out_shape(self) -> tuple[int, ...]:
        """The sums' (and their cotangent's) shape."""
        return (self.b_tot, self.c) + ((self.members,) if self.members else ())


def _pair_step(st: PairStatic, term, s: int, coord, mask, ext, shift_s, nbr_s, inv_s):
    """One half offset of the plain sweep: its per-atom sums (B, C)."""
    safe = nbr_s.clamp(min=0).long()
    cj = coord[safe] + shift_s[:, None, :]
    diff = cj[:, None, :, :] - coord[:, :, None, :]
    real = mask > 0.5
    vp = real[:, :, None] & real[safe][:, None, :] & (nbr_s >= 0)[:, None, None]
    if s == 0:  # the zero offset: drop the self pair
        vp = vp & ~torch.eye(st.c, dtype=torch.bool, device=coord.device)[None]
    d2 = (diff * diff).sum(-1)
    d = torch.sqrt(torch.where(vp, d2, torch.ones_like(d2)))
    vp = vp & (d < st.cutoff)
    val = pair_value(term, d, vp, ext, ext[safe])
    e = torch.where(vp if val.dim() == 3 else vp[..., None], val, 0.0)  # (B, Ci, Cj[, n])
    out = e.sum(2)  # receiver side
    if s > 0:
        # mirror side, back to the candidate bin by a gather through the
        # inverse table (the zero offset already enumerates both orderings)
        mirror = torch.cat([e.sum(1), e.new_zeros((1,) + e.shape[2:])])
        out = out + mirror[inv_s]
    return out


def pair_forward_plain(st: PairStatic, term, coord, mask, ext, shift, nbr, inv):
    """Plain version of kernel D: per-atom sums (B, C), (B, C, n) for a
    member form.

    coord (B, C, 3), mask (B, C), ext (B, C, K), shift (S, B, 3) cartesian
    lattice shifts added to the candidates, nbr (S, B) candidate bins (-1
    where a gas-phase step has none), inv (S, B) the bin whose step s has
    each bin as its candidate (B where none).  Each offset is checkpointed,
    so a backward holds one offset's pair tensors at a time.
    """
    acc = coord.new_zeros(st.out_shape)
    for s in range(st.s_tot):
        acc = acc + checkpoint(
            _pair_step, st, term, s, coord, mask, ext, shift[s], nbr[s], inv[s], use_reentrant=False
        )
    return acc


def pair_backward_plain(st: PairStatic, term, coord, mask, ext, shift, nbr, inv, ct, create_graph: bool = False):
    """Plain version of kernel E: the VJP of :func:`pair_forward_plain`
    through torch.autograd, ``(grad_coord (B, C, 3), grad_ext (B, C, K),
    grad_shift (S, B, 3))`` for the cotangent ``ct`` (B, C).

    With ``create_graph`` the caller's ``coord``, ``ext``, ``shift`` and
    ``ct`` (leaves that require grad) stay in the graph: the tangents of
    PairAcc's second order (``PairAccBwd``).  A member form's ``ct`` is
    (B, C, n)."""
    with torch.enable_grad():
        if not create_graph:
            coord, ext, shift = (x.detach().requires_grad_(True) for x in (coord, ext, shift))
        out = pair_forward_plain(st, term, coord, mask, ext, shift, nbr, inv)
        return torch.autograd.grad(out, (coord, ext, shift), ct, create_graph=create_graph)


# ---------------------------------------------------------------------------
# kernel wrappers


def pair_counts_plain(st: PairStatic, coord, mask, shift, nbr, inv):
    """The real ordered pairs within the cutoff of each receiver row over the
    full stencil (B*C,) int64, with the distance rounded as the kernels round
    it: what their ``pair_counts`` diagnostic reads.  Each unordered pair
    counts at both ends, so the total is twice the half stencil's pairs."""
    real = mask > 0.5
    total = torch.zeros((st.b_tot, st.c), dtype=torch.int64, device=coord.device)
    for s in range(st.s_tot):
        safe = nbr[s].clamp(min=0).long()
        dx, dy, dz = ((coord[safe] + shift[s][:, None, :])[:, None, :, :] - coord[:, :, None, :]).unbind(-1)
        d = torch.sqrt((dx * dx + dy * dy) + dz * dz)
        ok = real[:, :, None] & real[safe][:, None, :] & (nbr[s] >= 0)[:, None, None] & (d < st.cutoff)
        if s == 0:
            ok &= ~torch.eye(st.c, dtype=torch.bool, device=coord.device)[None]
        total += ok.sum(-1)
        if s > 0:  # the candidate end, home through the inverse table
            total += torch.cat([ok.sum(-2), total.new_zeros((1, st.c))])[inv[s].long()]
    return total.reshape(-1)


def bin_boxes(coord, mask) -> torch.Tensor:
    """Each bin's box of real atoms, (B, 6) = [lo (3), hi (3)]; an empty
    bin's is empty (lo = +inf, hi = -inf).  The kernels skip an offset whose
    candidate box lies beyond the cutoff of the receiver."""
    real = (mask > 0.5)[..., None]
    lo = torch.where(real, coord, math.inf).amin(1)
    hi = torch.where(real, coord, -math.inf).amax(1)
    return torch.cat([lo, hi], dim=-1).contiguous()


def smem_bytes(st: PairStatic, adjoint: bool) -> int:
    """Shared memory of one kernel-D or kernel-E block (csrc/pair_walk.cuh::
    warp_words): per warp a queue of QUEUE pairs and the receiver's extras;
    E adds the (S, 3) shift rows."""
    return 4 * WARPS * (5 * QUEUE + st.k + (3 * st.s_tot if adjoint else 0))


def bwd_scratch_bytes(st: PairStatic) -> int:
    """Kernel E's device scratch: the per-receiver shift rows (B*C, S, 3)."""
    return 4 * st.b_tot * st.c * st.s_tot * 3


def blocks(st: PairStatic) -> int:
    """Blocks of kernels D and E: one warp per receiver slot row."""
    return -(-st.b_tot * st.c // WARPS)


def _check(st: PairStatic, term, **tensors) -> None:
    """Refuse what the kernels do not take: wrong device, dtype, shape, a
    non-contiguous layout, or extras wider than the kernels hold."""
    shapes = {
        "coord": (st.b_tot, st.c, 3),
        "mask": (st.b_tot, st.c),
        "ext": (st.b_tot, st.c, st.k),
        "shift": (st.s_tot, st.b_tot, 3),
        "nbr": (st.s_tot, st.b_tot),
        "inv": (st.s_tot, st.b_tot),
        "ct": st.out_shape,
        "pair_counts": (st.b_tot * st.c,),
    }
    dtypes = {"nbr": torch.int32, "inv": torch.int64, "pair_counts": torch.int32}
    for name, t in tensors.items():
        want = dtypes.get(name, torch.float32)
        if t.device.type != "cuda" or t.dtype != want or not t.is_contiguous():
            raise ValueError(f"{name}: the kernel takes a contiguous {want} CUDA tensor")
        if tuple(t.shape) != shapes[name]:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shapes[name]}")
    check_width(st, term)


def check_width(st: PairStatic, term) -> None:
    """The extras the kernels take: K = 2V + NS with the term's NS scalars
    and V <= MAX_V (the vector columns a lane of kernel E holds), within a
    block's shared memory; a member form's n <= MAX_MEMBERS members (the
    accumulators a lane holds) of its own scalars."""
    if isinstance(term, MemberTerm) != (st.members > 0) or (st.members and st.members != term.n):
        raise ValueError(f"members={st.members}: the term takes {getattr(term, 'n', 0)}")
    if st.members > MAX_MEMBERS:
        raise ValueError(f"pair kernels take member forms of at most {MAX_MEMBERS} members, not {st.members}")
    ns = len(term.scalar_keys)
    if st.ns != ns or st.k != 2 * st.v + ns or (not term.vector_keys and st.k != ns):
        raise ValueError(f"K={st.k}: the extras are [p (V), r (V), s ({ns})], K = 2V+{ns}")
    if st.v > MAX_V:
        raise ValueError(f"pair kernels take extras of V <= {MAX_V} columns, not {st.v}")
    if smem_bytes(st, adjoint=True) > SMEM_LIMIT:
        raise ValueError(f"pair kernels do not take K={st.k} extras at S={st.s_tot} (shared memory)")


def _consts(st: PairStatic, term) -> ctypes.Array:
    vals = (st.cutoff,) + tuple(term.consts())
    return (ctypes.c_float * N_CONSTS)(*vals, *([0.0] * (N_CONSTS - len(vals))))


def _stream(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def _counts_ptr(pair_counts) -> ctypes.c_void_p:
    return ctypes.c_void_p(0) if pair_counts is None else ptr(pair_counts)


def pair_sweep_forward(st: PairStatic, term, coord, mask, ext, shift, nbr, inv, pair_counts=None):
    """Kernel D: per-atom sums (B, C) of ``term`` over the half stencil,
    (B, C, n) for a member form.
    Arguments as :func:`pair_forward_plain`; ``nbr`` is int32 on the card.

    ``pair_counts``, a (B*C,) int32 CUDA tensor, receives the ordered pairs
    each receiver row contracted (a diagnostic; see :func:`pair_counts_plain`).
    """
    if coord.device.type == "cpu":
        if pair_counts is not None:
            raise ValueError("pair_counts: only the kernel counts its pairs")
        return pair_forward_plain(st, term, coord, mask, ext, shift, nbr, inv)
    counts = {} if pair_counts is None else {"pair_counts": pair_counts}
    _check(st, term, coord=coord, mask=mask, ext=ext, shift=shift, nbr=nbr, inv=inv, **counts)
    out = torch.empty(st.out_shape, dtype=torch.float32, device=coord.device)
    consts = _consts(st, term)
    box = bin_boxes(coord, mask)
    launch = bind("pair_fwd", "pair_fwd_launch", 10, 6)
    err = launch(
        ctypes.cast(consts, ctypes.c_void_p), ptr(coord), ptr(mask), ptr(ext), ptr(shift), ptr(nbr),
        ptr(inv), ptr(box), ptr(out), _counts_ptr(pair_counts), term.code, st.members, st.b_tot, st.c, st.k,
        st.s_tot, _stream(coord),
    )
    if err != 0:
        raise RuntimeError(f"pair kernel D launch failed: cudaError {err}")
    pair_sweep_forward.launches += 1
    return out


pair_sweep_forward.launches = 0


def pair_sweep_backward(st: PairStatic, term, coord, mask, ext, shift, nbr, inv, ct, pair_counts=None):
    """Kernel E: ``(grad_coord (B, C, 3), grad_ext (B, C, K), grad_shift
    (S, B, 3))`` for the cotangent ``ct`` (B, C), (B, C, n) for a member
    form, of :func:`pair_sweep_forward`.

    Per pair the cotangent is ``ct_i + ct_j`` (at the zero offset ``ct_i``
    on ``c_ij`` and ``ct_j`` on ``c_ji``).  Every adjoint is the receiver's
    own row; the shift adjoint arrives as per-receiver rows (B*C, S, 3),
    added here over each bin's atoms.  ``pair_counts`` as in
    :func:`pair_sweep_forward`.
    """
    if coord.device.type == "cpu":
        if pair_counts is not None:
            raise ValueError("pair_counts: only the kernel counts its pairs")
        return pair_backward_plain(st, term, coord, mask, ext, shift, nbr, inv, ct)
    counts = {} if pair_counts is None else {"pair_counts": pair_counts}
    _check(st, term, coord=coord, mask=mask, ext=ext, shift=shift, nbr=nbr, inv=inv, ct=ct, **counts)
    dev = coord.device
    gc = torch.empty((st.b_tot, st.c, 3), dtype=torch.float32, device=dev)
    ge = torch.empty((st.b_tot, st.c, st.k), dtype=torch.float32, device=dev)
    rows = torch.empty((st.b_tot, st.c, st.s_tot, 3), dtype=torch.float32, device=dev)
    consts = _consts(st, term)
    box = bin_boxes(coord, mask)
    launch = bind("pair_bwd", "pair_bwd_launch", 13, 6)
    err = launch(
        ctypes.cast(consts, ctypes.c_void_p), ptr(coord), ptr(mask), ptr(ext), ptr(shift), ptr(nbr),
        ptr(inv), ptr(box), ptr(ct), ptr(gc), ptr(ge), ptr(rows), _counts_ptr(pair_counts), term.code,
        st.members, st.b_tot, st.c, st.k, st.s_tot, _stream(coord),
    )
    if err != 0:
        raise RuntimeError(f"pair kernel E launch failed: cudaError {err}")
    pair_sweep_backward.launches += 1
    return gc, ge, rows.sum(1).transpose(0, 1)


pair_sweep_backward.launches = 0


class PairAcc(torch.autograd.Function):
    """The pair sweep with its fused adjoint (pair_sweep.pair_acc_hb).

    Differentiable in ``coord``, ``ext`` and ``shift`` (the lattice shifts
    carry the cell and strain gradients, i.e. stress), to second order: the
    backward is ``PairAccBwd``,
    kernel E on the card, whose own backward differentiates
    :func:`pair_backward_plain` by autograd.  JAX's Pallas pair sweep is
    first order only; its default binned pair route is the XLA scan, which
    is twice differentiable, and this is that route's analogue: the primal
    and the first adjoint stay on kernels D and E, and only the
    second-order tangents (an HVP, a dense Hessian, a force loss) run the
    plain version, as conv_pass.ConvAcc's do.  Nothing catches a kernel
    failure, and a first-order backward (no ``create_graph``) calls kernel
    E alone, as before.
    """

    @staticmethod
    def forward(ctx, coord, ext, shift, st, term, mask, nbr, inv):
        ctx.st, ctx.term = st, term
        ctx.save_for_backward(coord, ext, shift, mask, nbr, inv)
        return pair_sweep_forward(st, term, coord, mask, ext, shift, nbr, inv)

    @staticmethod
    def backward(ctx, ct):
        coord, ext, shift, mask, nbr, inv = ctx.saved_tensors
        ct = ct.contiguous()
        if torch.is_grad_enabled():  # create_graph: the adjoint must itself be differentiable
            grads = PairAccBwd.apply(coord, ext, shift, ct, ctx.st, ctx.term, mask, nbr, inv)
        else:  # first order: kernel E alone, no node to record
            grads = pair_sweep_backward(ctx.st, ctx.term, coord, mask, ext, shift, nbr, inv, ct)
        return (*grads, None, None, None, None, None)


class PairAccBwd(torch.autograd.Function):
    """PairAcc's adjoint as a differentiable function of ``coord``, ``ext``,
    ``shift`` and the cotangent ``ct``: kernel E (or its plain version on
    the CPU) forward; backward the VJP of :func:`pair_backward_plain`, the
    second-order tangents."""

    @staticmethod
    def forward(ctx, coord, ext, shift, ct, st, term, mask, nbr, inv):
        ctx.st, ctx.term = st, term
        ctx.save_for_backward(coord, ext, shift, ct, mask, nbr, inv)
        return pair_sweep_backward(st, term, coord, mask, ext, shift, nbr, inv, ct)

    @staticmethod
    def backward(ctx, t_coord, t_ext, t_shift):
        coord, ext, shift, ct, mask, nbr, inv = ctx.saved_tensors
        with torch.enable_grad():
            leaves = [x.detach().requires_grad_(True) for x in (coord, ext, shift, ct)]
            adj = pair_backward_plain(ctx.st, ctx.term, leaves[0], mask, leaves[1], leaves[2], nbr, inv,
                                      leaves[3], create_graph=True)
            grads = torch.autograd.grad(adj, leaves, (t_coord, t_ext, t_shift), allow_unused=True)
        return (*grads, None, None, None, None, None)
