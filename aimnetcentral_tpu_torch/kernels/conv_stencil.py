"""The stencil ConvSV contraction and its adjoint: CUDA kernels and plain versions.

Replaces the two Pallas TPU kernels of aimnetcentral_tpu/kernels/conv_stencil.py:

- ``conv_stencil_forward`` (kernel A, csrc/conv_fwd.cu) replaces
  ``_fwd_kernel`` (conv_stencil.py:289).  For every receiver bin b, stencil
  offset s and pair (i in b, j in the candidate bin nbr[s, b]) within rc:
  ``gs_g = exp(-eta (d - s_g)^2) fc(d)``, ``u = r_ij / d`` and
  ``out[b, k, i, g, f] += W_k[i, j, g] a[j, g, f]`` with
  ``W = [gs, gs u_x, gs u_y, gs u_z]``.  The self pair is dropped only at
  the zero offset (s = 0): in a box with fewer than 2r+1 bins per axis the
  same bin recurs at other offsets as a real periodic image.
- ``conv_stencil_backward`` (kernel B, csrc/conv_bwd.cu plus one gather)
  replaces ``_bwd_kernel`` (conv_stencil.py:466) and the reassembly in
  conv_pallas.py::conv_bwd_acc.  Given the output cotangent it returns the
  feature, coordinate and lattice-shift adjoints.
  ``conv_stencil_backward_constants`` is the same kernel's second build,
  which also returns the adjoints of the AEV constants (the radial shifts,
  eta and rc): training differentiates them, as the JAX package's XLA
  engine does; inference never asks for them.

Both kernels run one warp per receiver atom and contract only the real
pairs within rc, which a ballot over the candidate slots picks out; FP32 on
CUDA cores (the exact tier has no TF32) with no float atomics: every output
element is owned by one block and every sum has a fixed order, so results
are deterministic.  Each kernel also has tensor-core builds, one for each
of the JAX package's conv precision modes (conv_stencil.py::_mxu_dot):
``mode`` "tf32", "3xtf32" or "bf16" (``MMA_MODES``, csrc/conv_mma.cuh)
rounds the contraction's operands as that mode does and contracts with
``mma.sync``; "fp32" is the FP32 build.  kernels/conv_pass.py::
resolve_conv_mode picks the mode from ``conv_precision`` and the ambient.
The plain versions take the same ``mode`` and emulate the rounding
(``round_tf32`` is ``cvt.rna.tf32.f32`` bit for bit).  The tensor-core
builds take all of a bin's real rows in one block (in passes of
``MMA_ROW_CAP``, so B's partner rows need no atom-tile axis) over a stream
of live candidates, found by a scan kernel launched before them and staged
into shared memory; their launch geometry is a pure function of the shapes
(``mma_fwd_tiles``, ``mma_bwd_tiles``, ``mma_row_groups``,
``mma_fwd_smem_bytes``, ``mma_bwd_smem_bytes``, ``mma_scan_words``).  What
bounds them on an H100 and what the design does about it is in the notes at
the top of each source.  A G*F row wider than one build's lanes hold (a
fused ensemble's member-stacked features) is cut into column tiles, a grid
axis of both kernels (``col_tiles``).

Each wrapper takes its plain PyTorch version only for tensors on the CPU;
for CUDA tensors it launches the kernel or raises.  ``launches`` on each
wrapper counts its kernel launches, every build; ``builds`` counts them by
mode.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math

import torch
from torch.utils.checkpoint import checkpoint

from aimnetcentral_tpu_torch.kernels.build import bind as _bind
from aimnetcentral_tpu_torch.kernels.build import ptr as _ptr

WARPS = 8  # receiver atoms a block of kernels A and B, one warp each
LANE_COLUMNS = (9, 17)  # columns of the G*F row a lane may own (the kernels' builds)
MAX_COL_TILES = 8  # column tiles of one launch: G*F <= 8 x 544 = 4,352
SMEM_LIMIT = 232_448  # bytes of shared memory one block may use on Hopper
MMA_MODES = {"tf32": 1, "3xtf32": 2, "bf16": 3}  # the tensor-core builds (csrc/conv_mma.cuh)
CONV_MODES = ("fp32", *MMA_MODES)  # "fp32": the FP32 builds on the CUDA cores
# the tensor-core builds' tiles (csrc/conv_mma.cuh): real rows a block (A) or
# a pass (B), feature columns a block, radial shifts an A and a B block,
# entries a batch of A and of B
MMA_ROW_CAP, MMA_F_TILE, MMA_FWD_G_TILE, MMA_BWD_G_TILE = 32, 24, 4, 8
MMA_FWD_ENTRIES, MMA_BWD_ENTRIES = 32, 16
MMA_THREADS = 256  # a block of either build, and of the scan before it
MMA_CONST_G = 2 * MMA_BWD_G_TILE  # B's constants' build: G <= 16, F <= MMA_F_TILE
MMA_BWD_MAX_TILES = 128  # B's shift-and-column tiles: the partials' scratch


@dataclasses.dataclass(frozen=True)
class ConvStatic:
    """Static shapes of one stencil conv: B bins of capacity C, G radial
    shifts, F feature columns per shift, S stencil offsets."""

    b_tot: int
    c: int
    g: int
    f: int
    s_tot: int


# ---------------------------------------------------------------------------
# plain versions


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32`` on f32 values: round to nearest, ties away from
    zero, to 10 mantissa bits (the low 13 bits cleared).  Subnormals round
    on the same bits; the largest finite values round to infinity, as the
    hardware rounds them; infinities and NaN pass through."""
    bits = x.contiguous().view(torch.int32)
    rounded = ((bits + 0x1000) & -0x2000).view(torch.float32)  # the sign bit stays: the magnitude rounds
    return torch.where(torch.isfinite(x), rounded, x)


def round_bf16(x: torch.Tensor) -> torch.Tensor:
    """``__float2bfloat16_rn``: round to nearest even, 8 mantissa bits."""
    return x.to(torch.bfloat16).to(torch.float32)


def _mode_einsum(eq: str, x: torch.Tensor, y: torch.Tensor, mode: str) -> torch.Tensor:
    """One contraction of the kernels in ``mode``: the operands rounded as
    the tensor cores take them, the products and sums in FP32.  The rounded
    values are TF32 numbers, so a TF32 matmul takes them unchanged and
    their products are exact in f32 at any ambient."""
    if mode == "tf32":
        return torch.einsum(eq, round_tf32(x), round_tf32(y))
    if mode == "bf16":
        return torch.einsum(eq, round_bf16(x), round_bf16(y))
    xh, yh = round_tf32(x), round_tf32(y)
    xl, yl = round_tf32(x - xh), round_tf32(y - yh)
    return torch.einsum(eq, xl, yh) + torch.einsum(eq, xh, yl) + torch.einsum(eq, xh, yh)


class _ModeContract(torch.autograd.Function):
    """``out[b,k,i,g,f] = sum_j W[b,k,i,j,g] a[b,j,g,f]`` in a tensor-core
    mode, with the adjoint kernel B takes: ``wbar = gbar . a`` over f and
    ``grad_a = W . gbar`` over (k, i), each with its operands rounded."""

    @staticmethod
    def forward(ctx, w, a_cand, mode):
        ctx.mode = mode
        ctx.save_for_backward(w, a_cand)
        return _mode_einsum("bkijg,bjgf->bkigf", w, a_cand, mode)

    @staticmethod
    def backward(ctx, gout):
        w, a_cand = ctx.saved_tensors
        gw = _mode_einsum("bkigf,bjgf->bkijg", gout, a_cand, ctx.mode)
        ga = _mode_einsum("bkijg,bkigf->bjgf", w, gout, ctx.mode)
        return gw, ga, None


def _pair_geometry(st: ConvStatic, s: int, coord, mask, shift_s, nbr_s, rc, mode: str):
    """One stencil offset's pairs: ``diff`` (B, Ci, Cj, 3) = (x_j + shift)
    - x_i, ``d`` and ``fc``.  The tensor-core modes round each operation on
    its own in the order their builds take (csrc/conv_mma.cuh::
    pair_geometry), so that their W is this W bit for bit and no rounding
    of it to TF32 or bf16 goes the other way; "fp32" keeps the formulas
    every FP32 gate was measured with."""
    c = st.c
    cj = coord[nbr_s] + shift_s[:, None, :]
    diff = cj[:, None, :, :] - coord[:, :, None, :]  # (B, Ci, Cj, 3)
    if mode == "fp32":
        d2 = (diff * diff).sum(-1)
    else:
        dx, dy, dz = diff.unbind(-1)
        d2 = dx * dx + dy * dy + dz * dz
    real_i = (mask > 0.5)[:, :, None]
    real_j = (mask[nbr_s] > 0.5)[:, None, :]
    vp = real_i & real_j
    if s == 0:  # the zero offset: drop the self pair
        vp = vp & ~torch.eye(c, dtype=torch.bool, device=coord.device)[None]
    d = torch.sqrt(torch.where(vp, d2, torch.ones_like(d2)))
    within = vp & (d < rc)
    if mode == "fp32":
        fc = torch.where(within, 0.5 * (torch.cos(torch.minimum(d, rc) * (math.pi / rc)) + 1.0), 0.0)
    else:
        pi_rc = torch.full((), math.pi, dtype=rc.dtype, device=rc.device) / rc
        fc = torch.where(within, 0.5 * (torch.cos(d * pi_rc) + 1.0), 0.0)
    return diff, d, fc


def _conv_step(st: ConvStatic, s: int, a_gmajor, coord, mask, shift_s, nbr_s, shifts_g, scal, mode: str = "fp32"):
    """One stencil offset of the plain forward: (B, 4, C, G, F)."""
    eta, rc = scal[0], scal[1]
    diff, d, fc = _pair_geometry(st, s, coord, mask, shift_s, nbr_s, rc, mode)
    dd = d[..., None] - shifts_g
    gs = torch.exp(-eta * dd * dd) * fc[..., None]  # (B, Ci, Cj, G)
    u = diff / d[..., None]
    w = torch.stack([gs] + [gs * u[..., k, None] for k in range(3)], dim=1)  # (B, 4, Ci, Cj, G)
    a_cand = a_gmajor[nbr_s].reshape(st.b_tot, st.c, st.g, st.f)
    if mode == "fp32":
        return torch.einsum("bkijg,bjgf->bkigf", w, a_cand)
    return _ModeContract.apply(w, a_cand, mode)


def conv_forward_plain(st: ConvStatic, a_gmajor, coord, mask, shift, nbr, shifts_g, scal, mode: str = "fp32"):
    """Plain version of kernel A (the twin of conv_pallas._conv_acc_xla).

    a_gmajor (B, C, G*F), coord (B, C, 3), mask (B, C), shift (S, B, 3)
    cartesian lattice shifts added to the candidates, nbr (S, B) candidate
    bins (-1 for a gas-phase step without one; its shift pushes the
    candidates out of range), shifts_g (G,), scal (2,) = [eta, rc].
    Returns (B, 4, C, G*F).  Each offset is checkpointed so a backward holds
    one offset's pair tensors at a time.  ``mode`` (``CONV_MODES``): the
    contraction of that build of kernel A, its operands rounded as the
    tensor cores take them (``_ModeContract``).
    """
    _check_mode(mode)
    acc = torch.zeros((st.b_tot, 4, st.c, st.g, st.f), dtype=a_gmajor.dtype, device=a_gmajor.device)
    nbr = nbr.clamp(min=0).long()
    for s in range(st.s_tot):
        acc = acc + checkpoint(
            _conv_step, st, s, a_gmajor, coord, mask, shift[s], nbr[s], shifts_g, scal, mode,
            use_reentrant=False,
        )
    return acc.reshape(st.b_tot, 4, st.c, st.g * st.f)


def conv_backward_plain(st: ConvStatic, a_gmajor, coord, mask, shift, nbr, shifts_g, scal, gbar,
                        create_graph: bool = False, constants: bool = False, mode: str = "fp32"):
    """Plain version of kernel B: the VJP of :func:`conv_forward_plain`
    through torch.autograd, in B's output frame ``(grad_a (B, C, G*F),
    grad_coord (B, C, 3), grad_shift (S, B, 3))``, and with ``constants``
    also ``grad_shifts_g (G,)`` and ``grad_scal (2,)`` (the plain version of
    :func:`conv_stencil_backward_constants`).  ``mode`` as the forward's:
    B's two contractions round their operands as that build does.

    With ``create_graph`` the caller's ``a_gmajor``, ``coord``, ``shift``
    and ``gbar`` (and with ``constants`` ``shifts_g`` and ``scal``; leaves
    that require grad) stay in the graph, so the adjoint can be
    differentiated again: the tangents of ConvAcc's second order
    (kernels/conv_pass.py::ConvAccBwd), which run in "fp32"."""
    if create_graph and mode != "fp32":
        raise ValueError("the second-order tangents run the plain version in 'fp32'")
    with torch.enable_grad():
        if not create_graph:
            a_gmajor, coord, shift = (x.detach().requires_grad_(True) for x in (a_gmajor, coord, shift))
            if constants:
                shifts_g, scal = (x.detach().requires_grad_(True) for x in (shifts_g, scal))
        out = conv_forward_plain(st, a_gmajor, coord, mask, shift, nbr, shifts_g, scal, mode)
        wrt = (a_gmajor, coord, shift) + ((shifts_g, scal) if constants else ())
        return torch.autograd.grad(out, wrt, gbar, create_graph=create_graph)


def pair_counts_plain(st: ConvStatic, coord, mask, shift, nbr, scal):
    """The real pairs within rc of each receiver row over the stencil,
    (B*C,) int64: what the kernels' ``pair_counts`` diagnostic reads."""
    rc = scal[1]
    nn = nbr.clamp(min=0).long()
    real = mask > 0.5
    total = torch.zeros((st.b_tot, st.c), dtype=torch.int64, device=coord.device)
    for s in range(st.s_tot):
        cj = coord[nn[s]] + shift[s][:, None, :]
        d = torch.sqrt(((cj[:, None, :, :] - coord[:, :, None, :]) ** 2).sum(-1))
        ok = real[:, :, None] & real[nn[s]][:, None, :] & (nbr[s] >= 0)[:, None, None] & (d < rc)
        if s == 0:
            ok &= ~torch.eye(st.c, dtype=torch.bool, device=coord.device)[None]
        total += ok.sum(-1)
    return total.reshape(-1)


# ---------------------------------------------------------------------------
# kernel wrappers


def _check(st: ConvStatic, **tensors) -> None:
    """Refuse what the kernels do not take: wrong device, dtype, shape or a
    non-contiguous layout."""
    shapes = {
        "a_gmajor": (st.b_tot, st.c, st.g * st.f),
        "coord": (st.b_tot, st.c, 3),
        "mask": (st.b_tot, st.c),
        "shift": (st.s_tot, st.b_tot, 3),
        "nbr": (st.s_tot, st.b_tot),
        "mnbr": (st.s_tot, st.b_tot),
        "shifts_g": (st.g,),
        "scal": (2,),
        "gbar": (st.b_tot, 4, st.c, st.g * st.f),
    }
    for name, t in tensors.items():
        want = torch.int32 if name in ("nbr", "mnbr") else torch.float32
        if t.device.type != "cuda" or t.dtype != want or not t.is_contiguous():
            raise ValueError(f"{name}: the kernel takes a contiguous {want} CUDA tensor")
        if tuple(t.shape) != shapes[name]:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shapes[name]}")


def col_tiles(st: ConvStatic) -> tuple[int, int, int]:
    """``(T, W, M)``: kernels A and B cut the G*F row into T column tiles
    of W columns (the last may be narrower), each lane owning M of a tile's
    columns (c = col0 + lane + 32 m, the smallest build that holds W).  A
    row that one build holds is one tile of W = G*F, the single model's
    launch; a wider one takes the fewest tiles of at most 32 x 17 columns,
    of equal width (a fused ensemble's 1,088 columns: two of 544; the NSE
    model's 1,152: three of 384)."""
    gf = st.g * st.f
    need = -(-gf // 32)
    tiles = -(-need // LANE_COLUMNS[-1])
    if tiles > MAX_COL_TILES:
        raise ValueError(f"conv kernels A and B take G*F <= {MAX_COL_TILES * 32 * LANE_COLUMNS[-1]}, not {gf}")
    lanes = -(-need // tiles)
    m = next(m for m in LANE_COLUMNS if lanes <= m)
    return tiles, (gf if tiles == 1 else 32 * lanes), m


def lane_columns(st: ConvStatic) -> int:
    """Columns of a tile each lane of kernels A and B owns (``col_tiles``)."""
    return col_tiles(st)[2]


def fwd_blocks(st: ConvStatic) -> int:
    """Kernel A's blocks: one warp per receiver slot row, WARPS rows a block."""
    return -(-st.b_tot * st.c // WARPS)


def bwd_tiles(st: ConvStatic) -> int:
    """Kernel B's atom tiles a bin: one block per (bin, tile of WARPS atoms)."""
    return -(-st.c // WARPS)


def bwd_scratch_bytes(st: ConvStatic) -> int:
    """Kernel B's device scratch: the partner rows (T, S, B, tiles of
    WARPS atoms, 3, C) and receiver rows (T, B, C, 3) of its T column tiles."""
    tiles = col_tiles(st)[0]
    return 4 * tiles * (st.s_tot * st.b_tot * bwd_tiles(st) * 3 * st.c + st.b_tot * st.c * 3)


def bwd_smem_bytes(st: ConvStatic, constants: bool = False) -> int:
    """Shared memory of one kernel-B block: two buffers of one partner row
    (3 x C) per warp; the constants' build reuses them for its per-warp
    column sums (G*F + 2 a warp) where those are larger
    (csrc/conv_bwd.cu::launch)."""
    rows = 4 * 2 * WARPS * 3 * st.c
    return max(rows, 4 * WARPS * (st.g * st.f + 2)) if constants else rows


def _check_mode(mode: str) -> None:
    if mode not in CONV_MODES:
        raise ValueError(f"mode must be one of {CONV_MODES}, not {mode!r}")


def mma_fwd_tiles(st: ConvStatic) -> int:
    """Kernel A's shift-and-column tiles in the tensor-core builds, a grid
    axis: MMA_FWD_G_TILE radial shifts by MMA_F_TILE feature columns."""
    return -(-st.g // MMA_FWD_G_TILE) * -(-st.f // MMA_F_TILE)


def mma_bwd_tiles(st: ConvStatic) -> int:
    """Kernel B's shift-and-column tiles in the tensor-core builds (MMA_BWD_G_TILE
    shifts): the T of its partial coordinate and partner-row outputs."""
    return -(-st.g // MMA_BWD_G_TILE) * -(-st.f // MMA_F_TILE)


def mma_row_groups(st: ConvStatic) -> int:
    """The most passes of MMA_ROW_CAP real rows a block of kernel A or B
    makes over its bin (a bin of C real atoms)."""
    return -(-st.c // MMA_ROW_CAP)


def _pitch_at(base: int, mod: int) -> int:
    """conv_mma.cuh::pitch_at: a pitch >= base, congruent to mod modulo 32."""
    return base + (mod - base) % 32


def _stage_mod(mode: str) -> int:
    return 4 if mode == "bf16" else 8


def mma_fwd_smem_bytes(st: ConvStatic, mode: str) -> int:
    """Shared memory of one kernel-A block in a tensor-core build
    (conv_mma.cuh::FwdLayout): a batch's (row, entry) geometry and exps, two
    batches of staged feature rows and coordinates, the pass's rows, the
    offsets' tables, the live masks (three classes of S x ceil(C / 32)
    words) and their prefix, the bin's slots."""
    q, cap, gt, eb = MMA_FWD_ENTRIES + 4, MMA_ROW_CAP, MMA_FWD_G_TILE, MMA_FWD_ENTRIES
    p = _pitch_at(gt * min(st.f, MMA_F_TILE), _stage_mod(mode))
    words = 48 * MMA_THREADS + cap * q * 4 + 2 * eb * 4 + 4 * cap + 4 * st.s_tot + gt * cap * q
    words = -(-words // 4) * 4 + 2 * eb * p
    words += gt + 4 * eb + st.s_tot + 3 * st.s_tot * -(-st.c // 32) + 3 * (st.s_tot + 1) + st.c
    return 4 * words


def mma_bwd_smem_bytes(st: ConvStatic, mode: str) -> int:
    """Shared memory of one kernel-B block in a tensor-core build, its
    constants' build too (conv_mma.cuh::BwdLayout): one batch of geometry,
    exps and staged cotangent rows, the two halves' (ubar, dbar), the pass's
    features, the live masks, the bin's slots."""
    q, cap, gt, eb = MMA_BWD_ENTRIES + 4, MMA_ROW_CAP, MMA_BWD_G_TILE, MMA_BWD_ENTRIES
    nf = min(st.f, MMA_F_TILE)
    pe = _pitch_at(4 * gt * nf, _stage_mod(mode))
    pr = _pitch_at(gt * nf, 4)
    words = cap * q * 4 + 2 * cap * eb * 4 + 4 * cap + 4 * st.s_tot + cap * q * 2 + gt * cap * q
    words = -(-words // 4) * 4 + eb * pe
    words = -(-words // 4) * 4 + cap * pr
    words += (gt + 6 * 8 + 3 * cap + 3 * st.s_tot * -(-st.c // 32) + 3 * (st.s_tot + 1) + st.c + 4 * eb
              + st.s_tot)
    return 4 * words


def mma_scan_words(st: ConvStatic) -> int:
    """Words of one (bin, pass) record of the live-candidate scan that runs
    before either tensor-core build (conv_mma.cuh::live_scan_kernel): three
    classes of S x ceil(C / 32) mask words and their prefix sums."""
    return 3 * st.s_tot * -(-st.c // 32) + 3 * (st.s_tot + 1)


def mma_scan_smem_bytes(st: ConvStatic) -> int:
    """Shared memory of one block of the live-candidate scan (ScanLayout)."""
    return 4 * (4 * MMA_ROW_CAP + 4 * st.s_tot + MMA_ROW_CAP + st.s_tot + mma_scan_words(st))


def _scan_records(st: ConvStatic, device) -> torch.Tensor:
    """The live-candidate scan's (bin, pass) records, scratch of one launch."""
    return torch.empty(st.b_tot * mma_row_groups(st) * mma_scan_words(st), dtype=torch.int32, device=device)


def _check_mma_launch(st: ConvStatic, mode: str, kernel: str, constants: bool = False) -> None:
    """Refuse, before any launch, what a tensor-core build does not take."""
    if kernel == "A":
        smem = mma_fwd_smem_bytes(st, mode)
    else:
        smem = mma_bwd_smem_bytes(st, mode)
        if constants and (st.g > MMA_CONST_G or st.f > MMA_F_TILE):
            raise ValueError(f"the AEV constants' adjoint takes one column tile (G <= {MMA_CONST_G} and "
                             f"F <= {MMA_F_TILE}), not G = {st.g}, F = {st.f}")
        if mma_bwd_tiles(st) > MMA_BWD_MAX_TILES:
            raise ValueError(f"conv kernel B ({mode}) takes at most {MMA_BWD_MAX_TILES} shift-and-column "
                             f"tiles, not G = {st.g}, F = {st.f}")
    smem = max(smem, mma_scan_smem_bytes(st))
    if smem > SMEM_LIMIT:
        raise ValueError(f"conv kernel {kernel} ({mode}) does not take C={st.c}, S={st.s_tot}, F={st.f}: "
                         f"{smem} bytes of shared memory a block")


def _counts_arg(st: ConvStatic, pair_counts, mode: str):
    """The optional per-row pair-count output of a kernel, as a pointer."""
    if pair_counts is None:
        return ctypes.c_void_p(0)
    if mode != "fp32":
        raise ValueError("pair_counts: the tensor-core builds count no pairs")
    if pair_counts.dtype != torch.int32 or tuple(pair_counts.shape) != (st.b_tot * st.c,) \
            or pair_counts.device.type != "cuda" or not pair_counts.is_contiguous():
        raise ValueError(f"pair_counts: the kernel takes a contiguous int32 CUDA tensor of "
                         f"shape ({st.b_tot * st.c},)")
    return _ptr(pair_counts)


def _count(wrapper, mode: str) -> None:
    wrapper.launches += 1
    wrapper.builds[mode] += 1


def conv_stencil_forward(st: ConvStatic, a_gmajor, coord, mask, shift, nbr, shifts_g, scal,
                         pair_counts=None, mode: str = "fp32"):
    """Kernel A: the stencil ConvSV contraction, (B, 4, C, G*F).  Arguments
    as :func:`conv_forward_plain`; ``nbr`` is int32 on the card.  ``mode``
    picks the build (``CONV_MODES``).

    ``pair_counts``, a (B*C,) int32 CUDA tensor, receives the pairs each
    receiver row contracted (a diagnostic of the FP32 build; the plain
    version has none).
    """
    _check_mode(mode)
    if a_gmajor.device.type == "cpu":
        if pair_counts is not None:
            raise ValueError("pair_counts: only the kernel counts its pairs")
        return conv_forward_plain(st, a_gmajor, coord, mask, shift, nbr, shifts_g, scal, mode)
    _check(st, a_gmajor=a_gmajor, coord=coord, mask=mask, shift=shift, nbr=nbr,
           shifts_g=shifts_g, scal=scal)
    counts = _counts_arg(st, pair_counts, mode)
    out = torch.empty((st.b_tot, 4, st.c, st.g * st.f), dtype=torch.float32, device=a_gmajor.device)
    stream = ctypes.c_void_p(torch.cuda.current_stream(a_gmajor.device).cuda_stream)
    if mode == "fp32":
        _tiles, width, cols = col_tiles(st)
        err = _bind("conv_fwd", "conv_fwd_launch", 9, 7)(
            _ptr(coord), _ptr(mask), _ptr(a_gmajor), _ptr(nbr), _ptr(shift), _ptr(shifts_g),
            _ptr(scal), _ptr(out), counts, st.b_tot, st.c, st.g, st.f, st.s_tot, cols, width, stream,
        )
    else:
        _check_mma_launch(st, mode, "A")
        rec = _scan_records(st, a_gmajor.device)
        err = _bind("conv_fwd", "conv_fwd_mma_launch", 9, 6)(
            _ptr(coord), _ptr(mask), _ptr(a_gmajor), _ptr(nbr), _ptr(shift), _ptr(shifts_g),
            _ptr(scal), _ptr(out), _ptr(rec), st.b_tot, st.c, st.g, st.f, st.s_tot, MMA_MODES[mode], stream,
        )
    if err != 0:
        raise RuntimeError(f"conv kernel A ({mode}) launch failed: cudaError {err}")
    _count(conv_stencil_forward, mode)
    return out


conv_stencil_forward.launches = 0
conv_stencil_forward.builds = dict.fromkeys(CONV_MODES, 0)


def gather_partner_adjoints(st: ConvStatic, nbr, dc_recv, pgrad):
    """Turn kernel B's receiver-side coordinate adjoint and its partner-side
    row sums into the full coordinate adjoint and the lattice-shift adjoint.

    ``pgrad[s, j, k, i]`` is the k-th coordinate adjoint of atom i of the
    bin whose forward step s had bin j as its candidate.  On a grid that is
    the bin ``p`` with ``nbr[s, p] == j``, so one static gather through
    ``nbr`` (no scatter) brings it home: ``dc = dc_recv + sum_s taken`` and
    ``ds[s, p] = -sum_i taken[s, p, :, i]`` (the pair displacement is
    x_j + shift - x_i).  Gas-phase steps without a candidate (nbr = -1)
    take nothing.
    """
    s_idx = torch.arange(st.s_tot, device=pgrad.device)[:, None]
    valid = (nbr >= 0).to(pgrad.dtype)[:, :, None, None]
    taken = pgrad[s_idx, nbr.clamp(min=0).long()] * valid  # (S, B, 3, C)
    dc = dc_recv + taken.sum(0).transpose(1, 2)
    ds = -taken.sum(-1)
    return dc, ds


def _launch_backward(st: ConvStatic, a_gmajor, coord, mask, shift, nbr, mnbr, shifts_g, scal, gbar,
                     pair_counts, constants: bool, mode: str):
    """Kernel B's launch (``constants``: its constants' build; ``mode``:
    the build) and the fixed-order sums after it; the caller counts the
    launch."""
    _check(st, a_gmajor=a_gmajor, coord=coord, mask=mask, shift=shift, nbr=nbr, mnbr=mnbr,
           shifts_g=shifts_g, scal=scal, gbar=gbar)
    mma = mode != "fp32"
    if mma:
        counts = _counts_arg(st, pair_counts, mode)
        _check_mma_launch(st, mode, "B", constants)
        tiles = mma_bwd_tiles(st)
        part_shape = (tiles, st.s_tot, st.b_tot, 3, st.c)  # one block a bin: no atom-tile axis
        cbar_shape = (st.b_tot, tiles, st.g + 2)
    else:
        tiles, width, cols = col_tiles(st)
        if constants and tiles > 1:
            raise ValueError(f"the AEV constants' adjoint takes one column tile (G*F <= {32 * LANE_COLUMNS[-1]}), "
                             f"not G = {st.g}, F = {st.f}")
        counts = _counts_arg(st, pair_counts, mode)
        if bwd_smem_bytes(st, constants) > SMEM_LIMIT:
            raise ValueError(f"conv kernel B does not take C={st.c}")
        part_shape = (tiles, st.s_tot, st.b_tot, bwd_tiles(st), 3, st.c)
        cbar_shape = (st.b_tot, bwd_tiles(st), st.g + 2)
    dev = a_gmajor.device
    stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
    grad_a = torch.empty((st.b_tot, st.c, st.g * st.f), dtype=torch.float32, device=dev)
    dc_recv = torch.empty((tiles, st.b_tot, st.c, 3), dtype=torch.float32, device=dev)
    pgrad = torch.empty(part_shape, dtype=torch.float32, device=dev)
    args = [_ptr(coord), _ptr(mask), _ptr(a_gmajor), _ptr(gbar), _ptr(mnbr), _ptr(shift),
            _ptr(shifts_g), _ptr(scal), _ptr(grad_a), _ptr(dc_recv), _ptr(pgrad)]
    cbar = torch.empty(cbar_shape, dtype=torch.float32, device=dev) if constants else None
    if mma:
        rec = _scan_records(st, dev)
        err = _bind("conv_bwd", "conv_bwd_mma_launch", 13, 7)(
            *args, _ptr(cbar) if constants else ctypes.c_void_p(0), _ptr(rec), st.b_tot, st.c, st.g, st.f,
            st.s_tot, MMA_MODES[mode], int(constants), stream)
    elif constants:
        err = _bind("conv_bwd", "conv_bwd_const_launch", 13, 7)(
            *args, counts, _ptr(cbar), st.b_tot, st.c, st.g, st.f, st.s_tot, cols, width, stream)
    else:
        err = _bind("conv_bwd", "conv_bwd_launch", 12, 7)(
            *args, counts, st.b_tot, st.c, st.g, st.f, st.s_tot, cols, width, stream)
    if err != 0:
        raise RuntimeError(f"conv kernel B ({mode}) launch failed: cudaError {err}")
    # the column tiles' partials, then (FP32 builds) the atom tiles' partial
    # row sums, each added in a fixed order
    if tiles > 1:
        dc_recv, pgrad = dc_recv.sum(0), pgrad.sum(0)
    else:
        dc_recv, pgrad = dc_recv[0], pgrad[0]
    dc, ds = gather_partner_adjoints(st, nbr, dc_recv, pgrad if mma else pgrad.sum(2))
    if not constants:
        return grad_a, dc, ds
    cb = cbar.reshape(-1, st.g + 2).sum(0)  # the blocks' partial sums
    return grad_a, dc, ds, cb[: st.g], cb[st.g :]


def conv_stencil_backward(st: ConvStatic, a_gmajor, coord, mask, shift, nbr, mnbr, shifts_g, scal, gbar,
                          pair_counts=None, mode: str = "fp32"):
    """Kernel B: ``(grad_a (B, C, G*F), grad_coord (B, C, 3), grad_shift
    (S, B, 3))`` for the output cotangent ``gbar`` (B, 4, C, G*F).

    ``mnbr`` (S, B) is the receiver-centric mirror of ``nbr``
    (ops/binned.py::mirror_stencil_tables), -1 where a step has no partner.
    ``pair_counts`` as in :func:`conv_stencil_forward`, per receiver atom j;
    ``mode`` the build.
    """
    _check_mode(mode)
    if a_gmajor.device.type == "cpu":
        if pair_counts is not None:
            raise ValueError("pair_counts: only the kernel counts its pairs")
        return conv_backward_plain(st, a_gmajor, coord, mask, shift, nbr, shifts_g, scal, gbar, mode=mode)
    out = _launch_backward(st, a_gmajor, coord, mask, shift, nbr, mnbr, shifts_g, scal, gbar, pair_counts,
                           constants=False, mode=mode)
    _count(conv_stencil_backward, mode)
    return out


conv_stencil_backward.launches = 0
conv_stencil_backward.builds = dict.fromkeys(CONV_MODES, 0)


def conv_stencil_backward_constants(st: ConvStatic, a_gmajor, coord, mask, shift, nbr, mnbr, shifts_g, scal,
                                    gbar, pair_counts=None, mode: str = "fp32"):
    """Kernel B's constants' build: :func:`conv_stencil_backward`'s three
    adjoints and those of the AEV constants, ``grad_shifts_g (G,)`` and
    ``grad_scal (2,)`` = (eta, rc).  Each block writes its G + 2 partial
    sums and they are added here in a fixed order (no float atomics).  One
    column tile only (G*F <= 544 in the FP32 build, G <= 16 and F <= 24 in
    the tensor-core builds: a single model's widths): a wider row raises
    ``ValueError``."""
    _check_mode(mode)
    if a_gmajor.device.type == "cpu":
        if pair_counts is not None:
            raise ValueError("pair_counts: only the kernel counts its pairs")
        return conv_backward_plain(st, a_gmajor, coord, mask, shift, nbr, shifts_g, scal, gbar, constants=True,
                                   mode=mode)
    out = _launch_backward(st, a_gmajor, coord, mask, shift, nbr, mnbr, shifts_g, scal, gbar, pair_counts,
                           constants=True, mode=mode)
    _count(conv_stencil_backward_constants, mode)
    return out


conv_stencil_backward_constants.launches = 0
conv_stencil_backward_constants.builds = dict.fromkeys(CONV_MODES, 0)
