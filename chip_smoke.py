#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA card and check it.

    python3 chip_smoke.py [--out results.json]

Two configurations at full width on the same 10,000-atom periodic box,
random weights from seed 0: flagship-10k (the flagship head set, DSF
Coulomb) and wb97m-d3-10k (the same heads plus the external DFT-D3(BJ) head
of the released ``aimnet2-wb97m-d3_*`` models); the same two on molecules,
batches, a small box and gas-phase clusters cut from the same geometry, and
in MD on them.

Phases (any failure exits nonzero; nothing is caught):

1. card: needs ``torch.cuda.is_available()``; prints the nvidia-smi name
   and power limit;
2. build: compiles the CUDA kernels from aimnetcentral_tpu_torch/csrc/
   (one nvcc per source, in parallel) and prints ptxas' registers, shared
   memory and spills;
3. kernels: each kernel against its plain PyTorch version on the same
   inputs at the main path's shapes, with times (CUDA events) and the least
   time the card could take: A and B on the 10,000-atom flagship grid of a
   request and on an MD driver's (skin 0.3 A) (F = 16 and F = 17), D and E
   on the request's LR grid for each pair term (DSF Coulomb, D3
   coordination number, D3 energy; the MD drivers' LR grid has the same
   shapes, which is checked, or D and E run again on it); each also
   against a plain run in f64 (no farther than twice the f32 plain), and
   the pairs each kernel contracted (its ``pair_counts`` output) against
   the plain count, row by row;
4. main path: for each configuration, three
   ``AIMNet2Calculator.eval(forces=True)`` requests with the kernels'
   launch counts read around them (A, B three times a request; D, E once
   on flagship-10k, three times on wb97m-d3-10k), ten more requests timed
   reusing the layout (their median is the request time) and ten building
   it (the request time before the layout reuse), a repeated request
   identical bit for bit, and a profiled request;
5. layers: host-clock times of binning and of each pair term's sweep,
   forward plus backward, through the kernels;
6. the card against the port's own CPU run (plain versions) on a
   500-atom box on the binned layouts (``CHECK_BOX``, ``CHECK_THRESHOLD``):
   energy (1e-5 relative, with a floor of
   one f32 rounding of every term the energy sums), forces and stress, for
   both configurations; on the ~1,200-atom box a calculator request after a
   sub-skin move reuses the prepared layout and equals a fresh calculator's within the absolute
   limits ``CHECK_ABS``, which the same request at the ``fast`` tier (the
   control) must exceed;
7. MD (``dynamics.MDDriver``, Langevin, dt 0.5 fs, 300 K, skin 0.3 A):
   on flagship-10k two chunks of 25 steps to run out the synthetic box's
   violent start, then four timed chunks of 25 steps at the default tier
   (``fast``) and four at ``exact``; on wb97m-d3-10k the same warm-up and
   one timed window at the default tier.  Each window: ms per step (its
   wall time over its steps, the chunks' spread beside it), steps/s,
   re-binnings per 100 steps, retried chunks, peak device memory and the
   idle share of one profiled chunk; gated on the kernels' launches per
   step (A, B 3; D, E 1 on flagship-10k, 3 on wb97m-d3-10k; re-binning
   steps add none), peak memory against the single request's, no growth
   of held memory.  The random-weight potential blows the box up after
   35-40 fs, so those windows are marked hot, not representative; the same
   measurements are taken over the first 50 steps of a fresh NVE driver at
   each tier, gated at ``exact`` on the total energy (within 1e-4 of
   itself); two drivers of one seed give the same coordinates bit for bit
   after 50 steps; on the 500-atom box, 3 NVE steps and 3 FIRE steps
   of wb97m-d3 on the card at the exact tier against the CPU, per-step
   energies and forces and final coordinates within ``CHECK_ABS``, with the
   same steps at ``fast`` as the control that must exceed them;
8. gas: molecules, batches, small boxes and gas-phase clusters at full
   width through ``AIMNet2Calculator.eval(forces=True)`` (``phase_gas``):
   mol-113 on both configurations, batch-8 (eight clusters of 40-120
   atoms as a list), periodic-500 (wb97m-d3, with stress), cluster-2000
   and cluster-3000 on the indexed layout, and cluster-10k-dsf (the
   flagship with DSF Coulomb) on the gas-phase binned grid; each gated on
   its launches (none on the indexed layout; A, B 3 and D, E 1 on the
   grid) and a bitwise repeat, with request times built and reused, peak
   memory and a profiled request; A, B, D and E against their plain
   versions on the 10k gas-phase grid as in phase 3; the card against the
   CPU on mol-113, batch-8, periodic-500 and a 500-atom DSF cluster;
9. packed: gas-phase batches at or above ``binned_threshold`` on the
   molecule-bin layout (one molecule a bin, capacity 120, every sweep at
   radius 0; ``phase_packed``): packed-64 (flagship, 64 clusters of 40-120
   atoms, simple Coulomb through D and E at cutoff inf) and packed-32x113
   (wb97m-d3), gated on launches (A, B 3; D, E 1 or 3 a request), a
   bitwise repeat, A, B, D and E against their plain versions on the
   layout (f64 and pair-count gates), the answer against the card's
   indexed layout (whose times are printed beside it) and, after a 2 A
   move of every atom, the kept layout against a fresh build bit for bit;
   the card against the CPU on an 8-molecule packed batch;
10. md_gas: MD off the periodic binned path (``phase_md_gas``): the first 50
   NVE steps of md-mol-113 (flagship, the indexed engine a cell-less
   system takes), md-periodic-500 (wb97m-d3, ``engine="indexed"``) and
   md-cluster-10k-dsf (``engine="binned"`` on a gas-phase grid), gated on
   launches, no overflow, fewer rebuilds than steps, NVE energy and a
   bitwise repeat; 10 steps of md-mol-113 on the card against the CPU;
11. artifact: a v2 artifact of wb97m-d3's weights, written by the port's
   ``train.export.export_model`` and loaded by ``AIMNet2Calculator(path)``
   (``phase_artifact``): its heads (SR Coulomb in the model, external
   simple Coulomb without its SR part, external D3); artifact-10k (the
   10,000-atom box, as phase 4, A, B 3 and D, E 4 a request) against the
   in-memory source model; D and E with each of its four pair terms (the
   SR Coulomb on the SR grid, DSF without its SR part and both D3 sweeps on
   the LR grid) against their plain versions, and again on
   artifact-packed-32x113's molecule bins; artifact-mol-113 and
   artifact-packed-32x113 (launches, times, a bitwise repeat, the host's
   spans); the card against the CPU on 500 atoms and an 8-molecule
   packed batch within ``CHECK_ABS``; a request with an element outside
   ``implemented_species`` refused without a launch;
12. integrations: the adapters and the command line on the card
   (``phase_integrations``), with tests/torch_fakes.py's fakes of ASE and
   of a TorchSim state: AIMNet2ASE on flagship-10k (ten requests with
   stress against ten direct ``eval`` requests on the same moved inputs,
   within ``CHECK_ABS``; A, B 3 and D, E 1 a request; the median ms of
   each path and the adapter's added host ms) and its ``get_hessian`` on
   mol-113 (``eval(hessian=True)`` reshaped bit for bit, symmetric, no
   launch); AIMNet2Pysis on mol-113 (forces in Hartree/Bohr, a repeat from
   the cache); AIMNet2TorchSim on packed-32x113 (wb97m-d3, molecule bins,
   A, B, D, E 3) and a 1,200-atom periodic state with stress (binned),
   positions on the card (launches as a direct request, results within
   ``CHECK_ABS`` of ``eval`` on the same batch, outputs on the card in
   float64, ms a call and the host round trip); the CLI's ``sp`` (mol-113
   xyz, the 1,200-atom box as CIF: the printed energy), ``md`` (NVE at 0 K,
   20 steps on the box: ``final_epot_eV`` against ``MDDriver`` on the
   calculator's binned System), ``relax``, ``freq``, ``neb`` and ``info``
   on phase 11's wb97m-d3 artifact, each against the direct API (through
   click's test runner, or the commands' plain bodies without click); the
   validation model of tools/validate_torch.py on the card against the
   committed tools/validate_baseline.json and against the CPU;: second derivatives at full width
   (``phase_second_order``): the dense Hessian of mol-113 (flagship and
   wb97m-d3) through ``AIMNet2Calculator.eval(hessian=True)`` at ``exact``
   (indexed, no launch), gated on being finite, symmetric, translation
   invariant and repeated bit for bit, and on H v for three seeded v (the
   dense product, ``hessian_vector_product`` on the card and the CPU's)
   within limits that the ``fast`` tier must exceed; the vibrations of
   mol-113 flagship (frequencies, IR intensities of every mode but the six
   projected null ones in one request of 666 molecules on molecule bins,
   A 3 and D 1 launches, RRHO) with 8 displaced molecules card against
   CPU; ``ts_search`` (3 steps) and ``neb`` (7 images, 5 iterations), the
   first Lanczos eigenvalue from one start and the first band's energies
   and forces card against CPU; the first dense Hessian of a fresh
   process against its repeats (a subprocess that differentiates nothing
   before it); and the K3 route, ``make_hvp_fn`` on the
   1,200-atom flagship box (binned, DSF) and on packed-8 (molecule bins,
   simple Coulomb): A, B, D and E as the primals (A 3, B 6, D 1, E 1)
   against the all-plain route on the card within a limit that the ``fast``
   tier must exceed, and the time of each route;
14. long_range: Ewald, PME, SRRep, DispParam, D3TS and a model without
   d2features at full width (``phase_long_range``): D and E with the
   real-space Ewald term (its SR part inside; on ewald-10k's LR grid at
   21.7 A and on the 1,200-atom box's, where one atom meets several images
   of a neighbour), SRRep (SR grid) and D3TS (LR grid) against their plain
   versions with the f64 and pair-count gates; ewald-10k, pme-10k,
   lr-heads-10k (SRRep, DispParam, D3TS on the flagship) and nod2-10k as
   phase 4 (launches A, B 3 and D, E 1, 1, 3, 1 a request; times, peak, a
   profiled request, a bitwise repeat), PME against Ewald within 2e-3 of
   max(1, |E|); ewald-periodic-500 (wb97m-d3, indexed, stress); the card
   against the CPU on 1,200 atoms (Ewald on a charged cell) and 500
   (PME, lr-heads) and on ewald-periodic-500; md-ewald-10k's first 50 NVE steps
   at exact, the same 25 fs at 0.25 fs (the NVE gate) and a bitwise repeat
   of two drivers; one Ewald HVP card against CPU with a ``fast`` control;
   the phase's seconds;
15. ensemble: four random flagship members (seeds 0-3) at full width and
   the exact tier (``phase_ensemble``): A and B at the fused forward's
   member-stacked widths (G*F = 1,024 and 1,088, column tiles) on the 10k
   request SR grid, beside the single model's 272, and the member forms of
   D and E at E = 4 (DSF on the fused request's LR grid, D3TS on
   lr-heads-10k's, the real-space Ewald sum on ewald-1200's, simple
   Coulomb on packed-8's molecule bins), each against its plain version
   with the f64 and pair-count gates; ens4-flagship-10k requests through
   ``EnsembleCalculator``, fused (A, B 3; D, E 1 a request) and per member
   (12 / 12 / 4 / 4), as phase 4, the fused energy and forces against the
   per-member path within ``CHECK_ABS``; ensemble MD at exact: 25 fs of
   NVE for members 1-3 alone and for the ensemble, each one's first step
   beyond ``MD_NVE_DRIFT`` (the random potentials collapse within
   20-40 fs), then the first 30 steps of an ens4-flagship-10k window
   timed and gated on ``MD_NVE_DRIFT``, ``epot_std`` finite and positive,
   and 3 steps on a 300-atom box card against CPU as the 1,200-atom MD
   check (``epot_std`` within the energy's limit); the card against the
   CPU on a 300-atom box with the lr-heads set and Ewald and on packed-8
   (energy 1e-5 relative, forces 1e-4 eV/A, ``energy_std`` 1e-5 of
   max(1, |E|), a bitwise repeat); the phase's seconds.

Then phase ``train`` (``phase_train``): the flagship configuration's
force-loss train step on molecule bins, on 256 gas-phase clusters of 16,
24, 32 and 48 atoms labelled by a second random-weight model (seed 1):
one 8-molecule step card against CPU at ``exact`` (loss 1e-5 relative,
each leaf's gradient within ten times the CPU f32 step's own error
against f64, a ``fast`` control that must exceed it); kernel B's
AEV-constants build (``conv_stencil_backward_constants``) against its
plain version at a 64-molecule batch's shapes, in f32 and against f64,
with its pair count, and no launch of it in any earlier phase; ten timed
steps a tier at 64 molecules (ms, molecules/s, peak memory, idle share,
launches a step: A 3, B's constants' build 6, D 1, E 2) and one profiled
step's device time by part; two steps from one state bit for bit;
``Trainer.fit`` for two epochs (the main path: its launches, its
history, ``train_loss`` falling) with a checkpoint after the first and a
resumed second epoch equal bit for bit; the CLI's ``calc-sae``, ``train``
and ``export`` bodies, the artifact on the card within ``CHECK_ABS``.

Then phase ``spatial`` (``phase_spatial``): one periodic box sharded over
ranks (aimnetcentral_tpu_torch/parallel/): one world of four ranks spawned
after the kernels are built (gloo on one card, the halo buffers staged
through the host; NCCL with a card a rank), on flagship-10k at full width
on one grid as JAX plans it (DSF at 15 A, a halo of three planes): a ring
of two and the 2 x 2 torus, energy and forces against the single-device
port on the same binned system (the JAX package's tests/test_spatial.py
limits), a bitwise repeat, each rank's A, B, D, E launches a request and
no plain call on the card, request, halo-exchange and all-reduce ms and
each rank's peak; 20 NVE steps of ``SpatialMDDriver`` on the ring against
the single-device velocity Verlet from the same state, and its NVE drift;
wb97m-d3 with Ewald and with PME on the ring (ewald-d3-10k, pme-d3-10k)
against the single-device port, PME against Ewald; A, B, D and E against
their plain versions on a ring shard's and a torus shard's extended grids
(their mixed-periodicity tables), as phase 3.

The last lines are the kernels' JSON record and
``{"ok": true, "device": {...}}``.  In the record, rows A and B are one
launch at F = 17; rows D and E are the three launches of one wb97m-d3-10k
request (DSF + D3 CN + D3 energy: times and bounds summed, the largest
error); rows named with "column tiles" and "member form" are the
ensemble phase's forms of A, B and of D, E (the fused request's and MD
step's shapes: A and B at G*F = 1,088, D and E DSF's member form on the
fused request's LR grid), counted over
the fused requests and the ensemble MD window; ``launches`` counts every main-path run (both configurations'
requests, the gas, packed, artifact and integrations phases' requests, the MD windows,
the second_order phase's IR request and kernel-route HVPs, the
long_range phase's requests and MD windows, the train phase's
``Trainer.fit`` and every rank's runs in the spatial phase); the last row is kernel B's AEV-constants build, counted
over that fit; and
``launches_per_md_step`` the launches per MD
step by configuration.  ``--out`` writes the full results (build logs,
per-F and per-term kernel detail, profiles) as JSON.  Imports nothing of
JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
N_MAIN = 10_000
N_CHECK = 1_200
CHECK_BOX = 500  # atoms of the card-against-CPU checks whose CPU side leads the run (as md-periodic-500)
CHECK_THRESHOLD = 256  # the calculators' binned_threshold there, so the 500-atom box keeps the binned layouts
N_TIMED = 10  # requests timed a configuration, after the three counted ones
N_BUILT_GAS = 5  # requests of a phase-gas input timed each building its layout (some take seconds)
FP32_PEAK = 67e12  # H100 SXM, FP32 outside the tensor cores (FLOP/s)
FP64_PEAK = 34e12  # H100 SXM, FP64 outside the tensor cores (FLOP/s; NVIDIA's data sheet)
HBM_RATE = 3.35e12  # H100 SXM device memory (bytes/s)
REL_TOL = 1e-5
F64_FLOOR = 2e-7  # two f32 roundings of the largest magnitude
F32_EPS = 2.0**-23  # f32 machine epsilon
# absolute limits of the 1,200-atom wb97m-d3 checks (layout reuse against a
# fresh build, MD and FIRE on the card against the CPU), from the noise
# measured on the card at the exact tier (PERF.md, "Findings"): energy two
# f32 units in the last place of the -164.5 eV total (measured: 0), forces
# 7x the largest measured (1.4e-6 eV/A), stress 4x (5.5e-9 eV/A^3),
# coordinates 5x (1.9e-6 A); the fast-tier controls came out at 1.5e-2 eV
# and 6.4e-4 eV/A
CHECK_ABS = {"energy": 3e-5, "forces": 1e-5, "stress": 2e-8, "coord": 1e-5}
MD_CHUNK = 25  # steps a chunk: the overflow check and the observables reach the host once per chunk
MD_WARM = 2  # chunks run before timing (the synthetic box starts violently)
MD_TIMED = 4  # timed chunks a window
MD_PEAK_RATIO = 1.25  # MD peak memory against the single request's
MD_HELD_GROWTH = 64 * 2**20  # bytes held after a window beyond those held before it
MD_NVE_DRIFT = 1e-4  # NVE total energy change over the first 50 steps at the exact tier, of itself
MD_SETTING = dict(dt_fs=0.5, temperature_K=300.0, thermostat="langevin", skin=0.3)  # bench.py:150
MD_CHECK_STEPS = 3  # NVE steps, and FIRE steps, of the MD check card against CPU
MD_CHECK_LAG = 0.49  # of the skin: the MD check's injected displacement since the last re-bin (one re-bin in step 1)
LR_CUTOFF = 15.0  # DSF's dsf_rc and the D3 cutoff of both configurations


def log(msg: str) -> None:
    print(msg, flush=True)


def build_box(n_atoms: int, density: float = 0.09, seed: int = 0):
    """Random organic-ish periodic box (CHNO, ~0.09 atoms/A^3) on a jittered
    lattice (a copy of bench.py::build_box)."""
    rng = np.random.default_rng(seed)
    a = (n_atoms / density) ** (1.0 / 3.0)
    m = int(np.ceil(n_atoms ** (1.0 / 3.0)))
    spacing = a / m
    grid = np.stack(np.meshgrid(*[np.arange(m)] * 3, indexing="ij"), axis=-1).reshape(-1, 3)[:n_atoms]
    coord = (grid + 0.5) * spacing + rng.uniform(-0.15, 0.15, size=(n_atoms, 3)) * spacing
    numbers = rng.choice([1, 6, 7, 8], size=n_atoms, p=[0.5, 0.35, 0.05, 0.1])
    cell = np.eye(3) * a
    return coord.astype(np.float32), numbers.astype(np.int32), cell.astype(np.float32)


def flagship_config():
    """The flagship head set at AIMNet2Config defaults (full width)."""
    from aimnetcentral_tpu_torch.models import AIMNet2Config
    from aimnetcentral_tpu_torch.models.heads import (
        AtomicShiftHead,
        AtomicSumHead,
        LRCoulombHead,
        OutputHead,
    )
    from aimnetcentral_tpu_torch.models.modules import MLPSpec

    return AIMNet2Config(
        outputs=(
            (
                "energy_mlp",
                OutputHead(
                    n_in=256, n_out=1, key_in="aim", key_out="energy",
                    mlp=MLPSpec(hidden=(128, 128), last_linear=True),
                ),
            ),
            ("atomic_shift", AtomicShiftHead(key_in="energy", key_out="energy")),
            ("atomic_sum", AtomicSumHead(key_in="energy", key_out="energy")),
            ("lrcoulomb", LRCoulombHead(rc=4.6, key_in="charges", key_out="energy")),
        )
    )


def wb97m_d3_config():
    """The released wB97M-D3 head set: the flagship's heads plus the
    external DFT-D3(BJ) head with the family's constants
    (aimnetcentral_tpu/data/model_registry.yaml:13-16)."""
    import dataclasses

    from aimnetcentral_tpu_torch.models.heads import DFTD3Head

    cfg = flagship_config()
    d3 = DFTD3Head(s8=0.3908, a1=0.566, a2=3.128, cutoff=15.0)
    return dataclasses.replace(cfg, outputs=cfg.outputs + (("external_dftd3", d3),))


def counters() -> dict:
    """The launch-counting wrappers of every kernel, by name."""
    from aimnetcentral_tpu_torch.kernels import conv_stencil as cs
    from aimnetcentral_tpu_torch.kernels import pair_sweep as ps

    return {
        "conv_stencil_forward": cs.conv_stencil_forward,
        "conv_stencil_backward": cs.conv_stencil_backward,
        "pair_sweep_forward": ps.pair_sweep_forward,
        "pair_sweep_backward": ps.pair_sweep_backward,
    }


def bound(nbytes: float, flops: float, flops64: float = 0.0) -> tuple[float, str]:
    """The least time (ms) for ``nbytes`` moved, ``flops`` FP32 operations
    and ``flops64`` FP64 ones (on their own units, so the slower of the two
    sets the operations' time)."""
    t_bytes = nbytes / HBM_RATE * 1e3
    t_ops = max(flops / FP32_PEAK, flops64 / FP64_PEAK) * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def time_cuda(fn, reps: int, warmup: int = 2) -> float:
    """Mean milliseconds per call over ``reps`` calls, CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def phase_card() -> str:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("FAIL: torch.cuda.is_available() is false: this check needs a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"[card] {smi}")
    log(f"[card] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    return smi


def phase_build() -> dict:
    from aimnetcentral_tpu_torch.kernels.build import LIBRARIES, SOURCES

    t0 = time.perf_counter()
    LIBRARIES.build()
    for name in SOURCES:
        LIBRARIES.get(name)
    seconds = time.perf_counter() - t0
    log(f"[build] {len(SOURCES)} kernels in {seconds:.2f} s")
    for name, text in LIBRARIES.logs.items():
        for line in text.splitlines():
            if any(w in line for w in ("registers", "spill", "smem", "error", "warning")):
                log(f"[build] {name}: {line.strip()}")
    return {"seconds": seconds, "logs": LIBRARIES.logs}


def rel64(x, ref) -> float:
    """Largest |x - ref| over the largest |ref|, in f64."""
    return float((x.double() - ref).abs().max() / ref.abs().max())


def phase_kernels(calc, sysb, label: str, fs: tuple[int, ...] | None = None) -> tuple[list[dict], dict]:
    """Kernels A and B against their plain versions on the binned system
    ``sysb`` (a layout the main path runs: a request's or an MD driver's),
    against a plain run in f64 (no farther than twice the f32 plain), and
    the pairs each contracted against the plain count, row by row.  ``fs``:
    the feature widths F of the two conv passes (default the model's F and
    F + charge channels; a fused ensemble's are E times those, its rows in
    column tiles); the f64 check and the record take the last."""
    import torch

    from aimnetcentral_tpu_torch.kernels import conv_stencil as cs
    from aimnetcentral_tpu_torch.kernels.conv_pass import build_conv_tables
    from aimnetcentral_tpu_torch.ops.binned import stencil_radius
    from aimnetcentral_tpu_torch.ops.math import cellmul

    dev = torch.device("cuda")
    grid = sysb.bins
    cfg = calc.cfg
    tab = build_conv_tables(grid, stencil_radius(cfg.aev.rc_s, grid))
    b, c, g = grid.total_bins, grid.capacity, cfg.nshifts
    aev = calc.params["aev"]
    if aev["shifts_s"].dim() == 2:  # member-stacked: the members share one architecture
        aev = {k: v[0] for k, v in aev.items()}
    fs = fs or (cfg.nfeature, cfg.nfeature + cfg.num_charge_channels)
    shift = torch.as_tensor(tab["push"], device=dev)
    if sysb.cell is not None:
        shift = shift + cellmul(torch.as_tensor(tab["wraps"], device=dev), sysb.cell[0])
    base = dict(
        coord=sysb.coord.detach().reshape(b, c, 3).contiguous(),
        mask=(sysb.numbers > 0).float().reshape(b, c).contiguous(),
        shift=shift.contiguous(),
        nbr=torch.as_tensor(tab["nbr"], device=dev),
        shifts_g=aev["shifts_s"].contiguous(),
        scal=torch.stack([aev["eta_s"], aev["rc_s"]]).contiguous(),
    )
    mnbr = torch.as_tensor(tab["mnbr"], device=dev)
    s_tot = tab["nbr"].shape[0]
    log(f"[kernels {label}] SR grid {grid.nbins} B={b} C={c} G={g} S={s_tot}")
    gen = torch.Generator(device=dev).manual_seed(1)
    n_pairs = None
    detail = {"grid": {"nbins": grid.nbins, "b": b, "c": c, "s": s_tot}}
    rows = {}
    for f in fs:
        st = cs.ConvStatic(b_tot=b, c=c, g=g, f=f, s_tot=s_tot)
        ops = dict(base, a_gmajor=0.3 * torch.randn((b, c, g * f), generator=gen, device=dev))
        gbar = torch.randn((b, 4, c, g * f), generator=gen, device=dev)
        if n_pairs is None:
            # the pairs each kernel contracted, read from its pair_counts
            # output, against the real ordered pairs within rc, row by row
            plain_rows = cs.pair_counts_plain(st, ops["coord"], ops["mask"], ops["shift"], ops["nbr"], ops["scal"])
            n_pairs = int(plain_rows.sum())
            counts_a = torch.zeros(b * c, dtype=torch.int32, device=dev)
            counts_b = torch.zeros_like(counts_a)
            cs.conv_stencil_forward(st, **ops, pair_counts=counts_a)
            cs.conv_stencil_backward(st, **ops, mnbr=mnbr, gbar=gbar, pair_counts=counts_b)
            real_rows = int((ops["mask"] > 0.5).sum())
            log(f"[kernels {label}] pairs contracted: A {int(counts_a.sum())}, B {int(counts_b.sum())}; "
                f"real ordered pairs within rc: {n_pairs}; distance tests {real_rows * s_tot * c} "
                f"(real receivers x offsets x capacity); a slot-dense stencil visits every slot pair: "
                f"{b * s_tot * c * c}")
            for key, counts in (("A", counts_a), ("B", counts_b)):
                if not torch.equal(counts.long(), plain_rows):
                    raise SystemExit(f"FAIL: kernel {key} contracted other pairs than the plain count on the "
                                     f"{label} layout")
            detail["pairs"] = n_pairs

        out_k = cs.conv_stencil_forward(st, **ops)
        torch.cuda.synchronize()
        out_p = cs.conv_forward_plain(st, **ops)
        err_a = float((out_k - out_p).abs().max())
        scale_a = float(out_p.abs().max())
        got = cs.conv_stencil_backward(st, **ops, mnbr=mnbr, gbar=gbar)
        torch.cuda.synchronize()
        ref = cs.conv_backward_plain(st, **ops, gbar=gbar)
        errs_b = {
            name: (float((x - y).abs().max()), float(y.abs().max()))
            for name, x, y in zip(("grad_a", "grad_coord", "grad_shift"), got, ref)
        }
        log(f"[kernels {label}] F={f} A: max_abs_err {err_a:.3e} rel {err_a / scale_a:.3e}")
        for name, (e, s) in errs_b.items():
            log(f"[kernels {label}] F={f} B {name}: max_abs_err {e:.3e} rel {e / s:.3e}")
        if err_a > REL_TOL * scale_a:
            raise SystemExit(f"FAIL: kernel A disagrees with its plain version at F={f} on the {label} layout")
        for name, (e, s) in errs_b.items():
            if e > REL_TOL * s:
                raise SystemExit(f"FAIL: kernel B {name} disagrees with its plain version at F={f} on the "
                                 f"{label} layout")

        if f == fs[-1]:
            # which side the differences come from: the kernels and the f32
            # plain versions, each against the plain versions in f64
            ops64 = {k: (v.double() if v.is_floating_point() else v) for k, v in ops.items()}
            out64 = cs.conv_forward_plain(st, **ops64)
            ref64 = cs.conv_backward_plain(st, **ops64, gbar=gbar.double())
            f64 = {"A out": (rel64(out_k, out64), rel64(out_p, out64))}
            f64.update({f"B {name}": (rel64(x, z), rel64(y, z))
                        for name, x, y, z in zip(("grad_a", "grad_coord", "grad_shift"), got, ref, ref64)})
            log(f"[kernels {label}] F={f} against f64, relative to the largest magnitude: "
                + "; ".join(f"{k}: kernel {a:.2e}, plain {b_:.2e}" for k, (a, b_) in f64.items()))
            for k, (a, b_) in f64.items():
                if a > max(2.0 * b_, F64_FLOOR):
                    raise SystemExit(f"FAIL: kernel {k} is farther from f64 than twice the f32 plain on the "
                                     f"{label} layout")
            detail["f64"] = f64
            del ops64, out64, ref64

        ms_a = time_cuda(lambda: cs.conv_stencil_forward(st, **ops), reps=20)
        ms_b = time_cuda(lambda: cs.conv_stencil_backward(st, **ops, mnbr=mnbr, gbar=gbar), reps=10)
        plain_a = time_cuda(lambda: cs.conv_forward_plain(st, **ops), reps=3, warmup=1)
        plain_b = time_cuda(lambda: cs.conv_backward_plain(st, **ops, gbar=gbar), reps=3, warmup=1)

        # least time: bytes read once / written once vs the FMAs the real
        # pairs need (4 rows x G x F per pair; B does two such contractions)
        feat = 4 * b * c * g * f
        small = 4 * (b * c * 4 + 2 * s_tot * b * 3 + s_tot * b)  # coord, mask, shifts, tables
        bytes_a = feat + 4 * feat + small
        bytes_b = feat + 4 * feat + feat + small + 4 * (b * c * 3 + s_tot * b * 3)
        flops_a = 2.0 * 4 * g * f * n_pairs
        flops_b = 2.0 * flops_a
        dense_a = 2.0 * b * s_tot * 4 * c * c * g * f

        tiles, width, _m = cs.col_tiles(st)
        log(f"[kernels {label}] F={f} (G*F = {g * f}) A: {cs.fwd_blocks(st)} x {tiles} blocks of {cs.WARPS} "
            f"receiver rows (a warp each) x {tiles} column tiles of {width} columns, {cs.lane_columns(st)} "
            f"columns a lane; B: {b} x {cs.bwd_tiles(st)} x {tiles} blocks of {cs.WARPS} atoms, "
            f"{cs.bwd_smem_bytes(st)} B dynamic shared memory, {cs.bwd_scratch_bytes(st)} B scratch")
        bound_a, by_a = bound(bytes_a, flops_a)
        bound_b, by_b = bound(bytes_b, flops_b)
        log(f"[kernels {label}] F={f} A: {ms_a:.3f} ms (plain {plain_a:.3f} ms), bound {bound_a:.4f} ms "
            f"by {by_a}; the pairs' work {flops_a / 1e9:.2f} GFLOP = {flops_a / ms_a / 1e9:.2f} "
            f"TFLOP/s (slot-dense work: {dense_a / 1e9:.1f} GFLOP); no single PyTorch call "
            f"computes this function (library_ms null)")
        log(f"[kernels {label}] F={f} B: {ms_b:.3f} ms (plain {plain_b:.3f} ms), bound {bound_b:.4f} ms "
            f"by {by_b}; the pairs' work {flops_b / 1e9:.2f} GFLOP = {flops_b / ms_b / 1e9:.2f} "
            f"TFLOP/s (slot-dense: {2 * dense_a / 1e9:.1f} GFLOP)")
        detail[f"F{f}"] = {
            "A": {"ms": ms_a, "plain_ms": plain_a, "bound_ms": bound_a, "bound_by": by_a,
                  "max_abs_err": err_a, "rel_err": err_a / scale_a, "bytes": bytes_a,
                  "flops_needed": flops_a, "flops_slot_dense": dense_a, "col_tiles": tiles, "tile_width": width},
            "B": {"ms": ms_b, "plain_ms": plain_b, "bound_ms": bound_b, "bound_by": by_b,
                  "errors": errs_b, "bytes": bytes_b, "flops_needed": flops_b,
                  "flops_slot_dense": 2 * dense_a},
        }
        rows[f] = (
            {"ms": ms_a, "plain_ms": plain_a, "bound_ms": bound_a, "bound_by": by_a,
             "max_abs_err": err_a},
            {"ms": ms_b, "plain_ms": plain_b, "bound_ms": bound_b, "bound_by": by_b,
             "max_abs_err": max(e for e, _s in errs_b.values())},
        )
        del ops, gbar, out_k, out_p, got, ref
        torch.cuda.empty_cache()

    # the record carries the F = 17 shapes (two of every three passes), or
    # the last of ``fs``
    row_a, row_b = rows[fs[-1]]
    kernels = [
        {"name": "conv_stencil_forward", "route": "cuda",
         "source": "aimnetcentral_tpu_torch/csrc/conv_fwd.cu",
         "replaces": "aimnetcentral_tpu/kernels/conv_stencil.py:289", "launches": None,
         **row_a, "library_ms": None},
        {"name": "conv_stencil_backward", "route": "cuda",
         "source": "aimnetcentral_tpu_torch/csrc/conv_bwd.cu",
         "replaces": "aimnetcentral_tpu/kernels/conv_stencil.py:466", "launches": None,
         **row_b, "library_ms": None},
    ]
    return kernels, detail


OPS_PER_PAIR = {  # FP32 operations (D, E) per unordered pair within the cutoff (csrc/pair_*.cu)
    "dsf": lambda v: (38, 75),
    "coulomb_simple": lambda v: (22, 51),
    "coulomb_sr": lambda v: (9, 22),
    "d3_cn": lambda v: (18, 42),
    "d3_energy": lambda v: (40 + 2 * v, 115 + 4 * v),
    "ewald_real": lambda v: (35, 70),
    "srrep": lambda v: (26, 60),
    "d3ts": lambda v: (40, 104),
}
OPS64_PER_PAIR = {"coulomb_sr": (12, 25)}  # FP64 ones: the SR Coulomb term's own (csrc/pair_terms.cuh)
# a member form's operations per unordered pair and per member beyond the
# first, FP32 (D, E) then FP64 (D, E): the charge product and its sum (D),
# the member's g, dg/dd, dg/dq, its pair cotangent and three sums (E); for
# D3TS the TS combination of C6 and alpha and its three derivatives
MEMBER_OPS = {
    "dsf": (3, 12, 0, 0),
    "coulomb_simple": (3, 12, 0, 0),
    "coulomb_sr": (1, 6, 2, 4),
    "ewald_real": (3, 12, 0, 0),
    "d3ts": (11, 36, 0, 0),
}


def pair_terms(calc, sysb, members: int = 0) -> dict:
    """The pair sweeps of a request on the binned system ``sysb``, as
    ``{name: (term, cutoff, extras, layout)}``: with random charges (seed 4)
    the SR Coulomb of a v2 artifact on the SR layout at its rc, DSF where
    the request's Coulomb is DSF, or simple Coulomb at cutoff inf on the
    molecule-bin layout; with a D3 head the coordination number and the D3
    energy over the C6 vectors of this system's coordination numbers (a
    wb97m-d3 request: DSF and both D3 sweeps; an artifact's: all four).
    Ewald and PME sweep their real-space sum (the SR part inside) at the
    attached cutoff; SRRep its GFN1 table's alpha and zeff on the SR layout
    at rc; D3TS positive random C6 and alpha (seed 4: what DispParam gives
    is the network's, random too) with the r4r2 table at 15 A.  Every sweep
    but the SR Coulomb and SRRep runs on the LR layout (the molecule-bin
    layout has one grid, which both names take).  With ``members`` the
    member forms of the sweeps that have one (DSF, simple, SR Coulomb,
    the real-space Ewald sum, D3TS), with random per-member charges, or C6
    and alpha (seed 4)."""
    import torch

    from aimnetcentral_tpu_torch.kernels import pair_sweep as ps
    from aimnetcentral_tpu_torch.models import engine_binned as eb
    from aimnetcentral_tpu_torch.models.heads import D3TSHead, DFTD3Head, LRCoulombHead, SRCoulombHead, SRRepHead

    named = calc._effective_cfg(sysb.cell is not None).outputs
    heads = [h for _n, h in named]
    sr = next((h for h in heads if isinstance(h, SRCoulombHead)), None)
    lr = next((h for h in heads if isinstance(h, LRCoulombHead)), None)
    d3 = next((h for h in heads if isinstance(h, DFTD3Head)), None)
    rep = next(((n, h) for n, h in named if isinstance(h, SRRepHead)), None)
    ts = next(((n, h) for n, h in named if isinstance(h, D3TSHead)), None)
    sweeps = []
    gen = torch.Generator(device="cuda").manual_seed(4)
    q = 0.3 * torch.randn(sysb.natoms, generator=gen, device="cuda") * (sysb.numbers > 0)
    if sr is not None:
        sweeps.append((ps.CoulombSRTerm(rc=sr.rc, envelope=sr.envelope), sr.rc, {"q": q}, "sr"))
    if rep is not None:
        gfn1 = calc.params["outputs"][rep[0]]["gfn1_ab"][sysb.numbers]
        term = ps.SRRepTerm(rc=rep[1].rc, cutoff_fn=rep[1].cutoff_fn)
        sweeps.append((term, rep[1].rc, {"alpha": gfn1[:, 0], "zeff": gfn1[:, 1]}, "sr"))
    if lr is not None and lr.method in ("ewald", "pme"):
        ew = ps.EwaldRealTerm(eta=sysb.ewald_eta_static[0], rc=lr.rc, envelope=lr.envelope,
                              subtract_sr=lr.subtract_sr)
        sweeps.append((ew, sysb.ewald_r_static, {"q": q}, "lr"))
    if lr is not None and lr.method == "dsf":
        dsf = ps.DSFTerm(alpha=lr.dsf_alpha, dsf_rc=lr.dsf_rc, rc=lr.rc, envelope=lr.envelope,
                         subtract_sr=lr.subtract_sr)
        sweeps.append((dsf, lr.dsf_rc, {"q": q}, "lr"))
    elif lr is not None and lr.method == "simple" and sysb.bins.molecule_bins:
        simple = ps.CoulombSimpleTerm(rc=lr.rc, envelope=lr.envelope, subtract_sr=lr.subtract_sr)
        sweeps.append((simple, math.inf, {"q": q}, "lr"))
    if d3 is not None:
        tables = calc.params["outputs"]["external_dftd3"]
        rcov = tables["rcov"][sysb.numbers]
        cn = eb.pair_sum_binned(sysb, d3.cutoff, ps.D3CNTerm(), {"rcov": rcov}, layout="lr")
        r_on = d3.cutoff * (1.0 - d3.smoothing_fraction)
        d3e = ps.D3EnergyTerm(a1=d3.a1, a2=d3.a2, s8=d3.s8, s6=d3.s6, r_on=r_on, r_off=d3.cutoff)
        sweeps.append((ps.D3CNTerm(), d3.cutoff, {"rcov": rcov}, "lr"))
        sweeps.append((d3e, d3.cutoff, eb.d3_pair_extras(sysb.species, sysb.numbers, cn, tables), "lr"))
    if ts is not None:
        real = sysb.numbers > 0
        c6 = torch.where(real, 2.0 + 38.0 * torch.rand(sysb.natoms, generator=gen, device="cuda"), 0.0)
        alpha = 3.0 + 12.0 * torch.rand(sysb.natoms, generator=gen, device="cuda")
        rr = calc.params["outputs"][ts[0]]["r4r2"][sysb.numbers]
        term = ps.D3TSTerm(a1=ts[1].a1, a2=ts[1].a2, s8=ts[1].s8, s6=ts[1].s6)
        sweeps.append((term, 15.0, {"c6": c6, "alpha": alpha, "rr": rr}, "lr"))
    if members:
        real = (sysb.numbers > 0)[:, None]
        wide = {
            "q": 0.3 * torch.randn((sysb.natoms, members), generator=gen, device="cuda") * real,
            "c6": torch.where(real, 2.0 + 38.0 * torch.rand((sysb.natoms, members), generator=gen, device="cuda"),
                              0.0),
            "alpha": 3.0 + 12.0 * torch.rand((sysb.natoms, members), generator=gen, device="cuda"),
        }
        sweeps = [(ps.MemberTerm(term, members), cutoff, {**extras, **{k: wide[k] for k in extras if k in wide}},
                   layout) for term, cutoff, extras, layout in sweeps if term.name in MEMBER_OPS]
    return {sweep[0].name: sweep for sweep in sweeps}


def _ops_per_pair(term, v: int) -> tuple[tuple[int, int], tuple[int, int]]:
    """FP32 and FP64 operations (D, E) per unordered pair of ``term`` with
    vectors of width ``v``: a member form's are the single term's with its
    product paid once per member (csrc/pair_terms.cuh's member functors)."""
    from aimnetcentral_tpu_torch.kernels.pair_sweep import MemberTerm

    if isinstance(term, MemberTerm):
        (d1, e1), (d64, e64) = _ops_per_pair(term.term, v)
        pd, pe, pd64, pe64 = MEMBER_OPS[term.term.name]
        extra = term.n - 1
        return (d1 + extra * pd, e1 + extra * pe), (d64 + extra * pd64, e64 + extra * pe64)
    return OPS_PER_PAIR[term.name](v), OPS64_PER_PAIR.get(term.name, (0, 0))


def _half_pair_count(st, ops) -> int:
    """Unordered real pairs within the cutoff on the half stencil, the
    distance rounded as the plain sweep and the kernels round it: the pairs
    the function needs."""
    import torch

    nbr = ops["nbr"].clamp(min=0).long()
    real = ops["mask"] > 0.5
    total = 0
    for s in range(st.s_tot):
        cj = ops["coord"][nbr[s]] + ops["shift"][s][:, None, :]
        dx, dy, dz = (cj[:, None, :, :] - ops["coord"][:, :, None, :]).unbind(-1)
        d = torch.sqrt((dx * dx + dy * dy) + dz * dz)
        ok = real[:, :, None] & real[nbr[s]][:, None, :] & (ops["nbr"][s] >= 0)[:, None, None] & (d < st.cutoff)
        if s == 0:  # the zero offset enumerates both orderings
            ok &= ~torch.eye(st.c, dtype=torch.bool, device=d.device)[None]
            total += int(ok.sum()) // 2
        else:
            total += int(ok.sum())
    return total


def _slot_tests(st, ops) -> int:
    """Candidate slots kernels D and E test: real receivers x capacity x
    the offsets of the full stencil whose candidate box is not beyond the
    cutoff (the skip of csrc/pair_walk.cuh, its margin included)."""
    import torch

    from aimnetcentral_tpu_torch.kernels import pair_sweep as ps

    coord, real = ops["coord"], ops["mask"] > 0.5
    box = ps.bin_boxes(coord, ops["mask"])
    limit = 1.0001 * st.cutoff**2 + 1e-6
    walked = 0
    for o in range(2 * st.s_tot - 1):
        lower = o >= st.s_tot
        h = o - st.s_tot + 1 if lower else o
        n = (ops["inv"][h] if lower else ops["nbr"][h]).long()
        has = (n >= 0) & (n < st.b_tot)
        n = torch.where(has, n, 0)
        sh = ops["shift"][h][n if lower else torch.arange(st.b_tot, device=n.device)][:, None, :]
        sgn = -1.0 if lower else 1.0
        e = torch.clamp(torch.maximum(box[n][:, None, :3] + sgn * sh - coord,
                                      coord - (box[n][:, None, 3:] + sgn * sh)), min=0.0)
        walked += int((real & has[:, None] & ((e * e).sum(-1) <= limit)).sum())
    return walked * st.c


def phase_pair_kernels(calc, sysb, label: str = "request", members: int = 0,
                       only: tuple[str, ...] | None = None) -> tuple[list[dict], dict]:
    """Kernels D and E against their plain versions on the layouts of the
    binned system ``sysb`` (a wb97m-d3-10k request's: three pair terms on
    the LR layout; a gas-phase DSF cluster's: one), for each pair term of
    ``pair_terms`` (those named in ``only`` when given): errors, the same against
    an f64 plain run, the pairs each kernel contracted, E's scratch, times.
    With ``members`` the member forms of the sweeps that have one
    (``pair_terms``)."""
    import torch

    from aimnetcentral_tpu_torch.kernels import pair_sweep as ps
    from aimnetcentral_tpu_torch.models import engine_binned as eb

    gen = torch.Generator(device="cuda").manual_seed(4)
    detail, sums = {}, {"D": {}, "E": {}}
    for name, (term, cutoff, extras, layout) in pair_terms(calc, sysb, members).items():
        if only is not None and name not in only:
            continue
        st, ops = eb.pair_operands(sysb, cutoff, term, extras, layout=layout)
        ops = {k: v.detach().contiguous() for k, v in ops.items()}
        ct = torch.randn(st.out_shape, generator=gen, device="cuda")
        n_pairs = _half_pair_count(st, ops)
        # the pairs each kernel contracted, read from its pair_counts output:
        # every unordered pair at both ends, each row its own plain count
        plain_rows = ps.pair_counts_plain(st, ops["coord"], ops["mask"], ops["shift"], ops["nbr"], ops["inv"])
        counts_d = torch.zeros(st.b_tot * st.c, dtype=torch.int32, device="cuda")
        counts_e = torch.zeros_like(counts_d)
        ps.pair_sweep_forward(st, term, **ops, pair_counts=counts_d)
        ps.pair_sweep_backward(st, term, **ops, ct=ct, pair_counts=counts_e)
        torch.cuda.synchronize()
        log(f"[kernels {label}] {name}: {layout.upper()} grid B={st.b_tot} C={st.c} S={st.s_tot} K={st.k}; "
            f"{n_pairs} unordered pairs within {cutoff} A; ordered pairs contracted (full stencil, "
            f"each pair at both ends): D {int(counts_d.sum())}, E {int(counts_e.sum())}, "
            f"2 x unordered = {2 * n_pairs}; slot tests {_slot_tests(st, ops)} of "
            f"{int((ops['mask'] > 0.5).sum()) * (2 * st.s_tot - 1) * st.c} without the box skip "
            f"(real receivers x {2 * st.s_tot - 1} offsets x capacity)")
        for key, counts in (("D", counts_d), ("E", counts_e)):
            if not torch.equal(counts.long(), plain_rows) or int(counts.sum()) != 2 * n_pairs:
                raise SystemExit(f"FAIL: kernel {key} contracted other pairs than the plain count for {name} ({label})")

        out_k = ps.pair_sweep_forward(st, term, **ops)
        torch.cuda.synchronize()
        out_p = ps.pair_forward_plain(st, term, **ops)
        err_d, scale_d = float((out_k - out_p).abs().max()), float(out_p.abs().max())
        got = ps.pair_sweep_backward(st, term, **ops, ct=ct)
        torch.cuda.synchronize()
        ref = ps.pair_backward_plain(st, term, **ops, ct=ct)
        names = ("grad_coord", "grad_ext", "grad_shift")
        errs_e = {
            k: (float((x - y).abs().max()), float(y.abs().max()))
            for k, x, y in zip(names, got, ref)
        }
        log(f"[kernels {label}] {name} D: max_abs_err {err_d:.3e} rel {err_d / scale_d:.3e}")
        for k, (e, sc) in errs_e.items():
            log(f"[kernels {label}] {name} E {k}: max_abs_err {e:.3e} rel {e / sc:.3e}")
        if err_d > REL_TOL * scale_d:
            raise SystemExit(f"FAIL: kernel D disagrees with its plain version for {name} ({label})")
        for k, (e, sc) in errs_e.items():
            if e > REL_TOL * sc:
                raise SystemExit(f"FAIL: kernel E {k} disagrees with its plain version for {name} ({label})")

        # which side the differences come from: the kernels and the f32 plain
        # versions, each against the plain versions in f64
        ops64 = {k: (v.double() if v.is_floating_point() else v) for k, v in ops.items()}
        out64 = ps.pair_forward_plain(st, term, **ops64)
        ref64 = ps.pair_backward_plain(st, term, **ops64, ct=ct.double())
        f64 = {"D out": (rel64(out_k, out64), rel64(out_p, out64))}
        f64.update({f"E {k}": (rel64(x, z), rel64(y, z)) for k, x, y, z in zip(names, got, ref, ref64)})
        log(f"[kernels {label}] {name} against f64, relative to the largest magnitude: "
            + "; ".join(f"{k}: kernel {a:.2e}, plain {b:.2e}" for k, (a, b) in f64.items()))
        for k, (a, b) in f64.items():
            if a > max(2.0 * b, F64_FLOOR):
                raise SystemExit(f"FAIL: kernel {k} of {name} is farther from f64 than twice the f32 plain ({label})")
        del ops64, out64, ref64

        ms_d = time_cuda(lambda: ps.pair_sweep_forward(st, term, **ops), reps=20)
        ms_e = time_cuda(lambda: ps.pair_sweep_backward(st, term, **ops, ct=ct), reps=20)
        plain_d = time_cuda(lambda: ps.pair_forward_plain(st, term, **ops), reps=3, warmup=1)
        plain_e = time_cuda(lambda: ps.pair_backward_plain(st, term, **ops, ct=ct), reps=3, warmup=1)
        # least time: inputs read once and outputs written once, against
        # the operations of the pairs within the cutoff
        ins = 4 * (st.b_tot * st.c * (4 + st.k) + st.s_tot * st.b_tot * 4) + 8 * st.s_tot * st.b_tot
        outs = 4 * st.b_tot * st.c * max(st.members, 1)  # the sums, or their cotangent
        bytes_d = ins + outs
        bytes_e = ins + outs + 4 * (st.b_tot * st.c * (3 + st.k) + st.s_tot * st.b_tot * 3)
        (ops_d, ops_e), (ops64_d, ops64_e) = _ops_per_pair(term, st.v)
        flops_d, flops_e = float(ops_d * n_pairs), float(ops_e * n_pairs)
        flops64_d, flops64_e = float(ops64_d * n_pairs), float(ops64_e * n_pairs)
        bound_d, by_d = bound(bytes_d, flops_d, flops64_d)
        bound_e, by_e = bound(bytes_e, flops_e, flops64_e)
        scratch = ps.bwd_scratch_bytes(st)
        log(f"[kernels {label}] {name} D: {ms_d:.3f} ms (plain {plain_d:.3f} ms), bound {bound_d:.4f} ms "
            f"by {by_d}; {ps.blocks(st)} blocks of {ps.WARPS} receiver rows (a warp each), "
            f"{ps.smem_bytes(st, adjoint=False)} B shared memory; no single PyTorch call "
            f"computes this function (library_ms null)")
        log(f"[kernels {label}] {name} E: {ms_e:.3f} ms (plain {plain_e:.3f} ms), bound {bound_e:.4f} ms "
            f"by {by_e}; {ps.smem_bytes(st, adjoint=True)} B shared memory; device scratch "
            f"{scratch} B (the per-receiver shift rows, {scratch / 2**20:.2f} MiB)")
        detail[name] = {
            "layout": layout, "grid": {"b": st.b_tot, "c": st.c, "s": st.s_tot, "k": st.k}, "pairs": n_pairs,
            "pairs_contracted": {"D": int(counts_d.sum()), "E": int(counts_e.sum())},
            "f64": f64, "scratch_bytes_e": scratch,
            "D": {"ms": ms_d, "plain_ms": plain_d, "bound_ms": bound_d, "bound_by": by_d,
                  "max_abs_err": err_d, "rel_err": err_d / scale_d, "bytes": bytes_d, "flops": flops_d,
                  "flops64": flops64_d},
            "E": {"ms": ms_e, "plain_ms": plain_e, "bound_ms": bound_e, "bound_by": by_e,
                  "errors": errs_e, "bytes": bytes_e, "flops": flops_e, "flops64": flops64_e},
        }
        for key, row, err in (
            ("D", detail[name]["D"], err_d),
            ("E", detail[name]["E"], max(e for e, _s in errs_e.values())),
        ):
            acc = sums[key]
            acc["ms"] = acc.get("ms", 0.0) + row["ms"]
            acc["plain_ms"] = acc.get("plain_ms", 0.0) + row["plain_ms"]
            for k in ("bytes", "flops", "flops64"):
                acc[k] = acc.get(k, 0.0) + row[k]
            acc["max_abs_err"] = max(acc.get("max_abs_err", 0.0), err)
        del ops, out_k, out_p, got, ref
        torch.cuda.empty_cache()

    rows = []
    for key, name, src, line in (
        ("D", "pair_sweep_forward", "pair_fwd.cu", 228),
        ("E", "pair_sweep_backward", "pair_bwd.cu", 283),
    ):
        acc = sums[key]
        b_ms, b_by = bound(acc["bytes"], acc["flops"], acc["flops64"])
        rows.append({
            "name": name, "route": "cuda", "source": f"aimnetcentral_tpu_torch/csrc/{src}",
            "replaces": f"aimnetcentral_tpu/kernels/pair_sweep.py:{line}", "launches": None,
            "max_abs_err": acc["max_abs_err"], "ms": acc["ms"], "plain_ms": acc["plain_ms"],
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        })
    return rows, detail


def phase_main_path(label: str, calc, coord, numbers, cell, per_request: dict) -> dict:
    """Three requests with every kernel's launches counted around them, ten
    more timed, a repeated request compared bit for bit, and a profiled
    request."""
    import torch

    rng = np.random.default_rng(2)
    requests = [coord] + [
        (coord + rng.normal(scale=0.05, size=coord.shape)).astype(np.float32) for _ in range(2)
    ]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    wrappers = counters()
    for fn in wrappers.values():
        fn.launches = 0
    times, energies, outputs = [], [], []
    for x in requests:
        t0 = time.perf_counter()
        out = calc.eval({"coord": x, "numbers": numbers, "cell": cell}, forces=True)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        e, f_ = out["energy"], out["forces"]
        if not (np.isfinite(e).all() and np.isfinite(f_).all()):
            raise SystemExit(f"FAIL: non-finite energy or forces on {label}")
        if f_.shape != (len(numbers), 3):
            raise SystemExit(f"FAIL: forces of shape {f_.shape}")
        net = float(np.abs(f_.astype(np.float64).sum(0)).max())
        total = float(np.abs(f_).sum())
        if net > 1e-5 * total:
            raise SystemExit(f"FAIL: net force {net} against sum |F| {total} on {label}")
        energies.append(float(e[0]))
        if not outputs:
            outputs.append(out)
        log(f"[main {label}] request: E = {e[0]:.6f} eV, |sum F| = {net:.3e} eV/A, "
            f"max |F| = {np.abs(f_).max():.4f} eV/A, {times[-1] * 1e3:.1f} ms")
    launches = {name: fn.launches for name, fn in wrappers.items()}
    log(f"[main {label}] launches over {len(requests)} requests: {launches}")
    for name, n in launches.items():
        if n != per_request[name] * len(requests):
            raise SystemExit(f"FAIL: {name} launched {n} times on {label}, expected "
                             f"{per_request[name]} per request")
    peak = torch.cuda.max_memory_allocated()
    # the request time: N_TIMED more requests cycling over the same three
    # inputs (the first request above carries the one-time warm-up)
    timed = []
    for k in range(N_TIMED):
        t0 = time.perf_counter()
        calc.eval({"coord": requests[k % len(requests)], "numbers": numbers, "cell": cell}, forces=True)
        torch.cuda.synchronize()
        timed.append(time.perf_counter() - t0)
    med = float(np.median(timed))
    # the same requests, each building its layout as every request did
    # before the calculator reused it
    built = []
    for k in range(N_TIMED):
        calc._prep_cache = None
        t0 = time.perf_counter()
        calc.eval({"coord": requests[k % len(requests)], "numbers": numbers, "cell": cell}, forces=True)
        torch.cuda.synchronize()
        built.append(time.perf_counter() - t0)
    med_built = float(np.median(built))
    log(f"[main {label}] the three requests: {', '.join(f'{t * 1e3:.1f}' for t in times)} ms; "
        f"{N_TIMED} more, reusing the layout: median {med * 1e3:.1f} ms, min {min(timed) * 1e3:.1f}, max "
        f"{max(timed) * 1e3:.1f}; {N_TIMED} more, each building its layout: median {med_built * 1e3:.1f} ms, "
        f"min {min(built) * 1e3:.1f}, max {max(built) * 1e3:.1f}; peak memory {peak / 2**30:.3f} GiB")

    # the first request once more, under the profiler: device time by kernel
    # name, and the main path is deterministic (no float atomics): the
    # answer repeats bit for bit
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        again = calc.eval({"coord": coord, "numbers": numbers, "cell": cell}, forces=True)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    for key in ("energy", "forces"):
        if not np.array_equal(again[key], outputs[0][key]):
            raise SystemExit(f"FAIL: a repeated request gave another {key} on {label}")
    log(f"[main {label}] a repeated request gives the same energy and forces bit for bit")

    # kernel-level events only: their op-level parents carry the same time
    events = [e for e in prof.key_averages() if str(getattr(e, "device_type", "")).endswith("CUDA")]
    dev_total = sum(dev_us(e) for e in events) / 1e3  # ms
    top = sorted(events, key=dev_us, reverse=True)[:12]
    # the profiler slows the host several times over, so the idle share is
    # taken against the unprofiled median wall time
    idle = max(0.0, 1 - dev_total / (med * 1e3))
    log(f"[main {label}] profiled request: wall {wall * 1e3:.1f} ms, device busy {dev_total:.1f} ms; "
        f"idle share against the unprofiled median {idle:.3f}")
    breakdown = []
    for e in top:
        ms = dev_us(e) / 1e3
        breakdown.append({"name": e.key[:90], "ms": ms, "count": e.count})
        log(f"[main {label}]   {ms:9.3f} ms  x{e.count:<5d} {e.key[:90]}")
    return {
        "launches": launches, "times_s": times, "timed_s": timed, "median_s": med, "built_s": built,
        "built_median_s": med_built, "peak_bytes": peak,
        "energies": energies, "profile": {"wall_ms": wall * 1e3, "device_ms": dev_total,
                                          "idle_share": idle, "top": breakdown},
    }


def phase_layers(calc, coord, numbers, cell) -> dict:
    """Host-clock time of layers of a wb97m-d3-10k request, each ending in a
    synchronize (median of three): binning (``prepare_system``), each pair
    term's sweep forward plus coordinate backward through kernels D and E,
    and the whole D3 head (both sweeps, the C6 vectors, both backwards)."""
    import torch

    from aimnetcentral_tpu_torch.models import engine_binned as eb
    from aimnetcentral_tpu_torch.models.heads import DFTD3Head

    data = {"coord": coord, "numbers": numbers, "cell": cell}

    def timed(fn) -> float:
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        return float(np.median(times))

    def fresh_prepare():
        calc._prep_cache = None  # a full build, not the reuse of the last layout
        return calc.prepare_system(data)

    t_prep = timed(fresh_prepare)
    sysb = calc.prepare_system(data)
    t_reuse = timed(lambda: calc.prepare_system(data))
    terms = pair_terms(calc, sysb)
    d3 = next(h for _n, h in calc.cfg.outputs if isinstance(h, DFTD3Head))
    tables = calc.params["outputs"]["external_dftd3"]
    r_on = d3.cutoff * (1.0 - d3.smoothing_fraction)

    def sweep(term, cutoff, ex, layout) -> None:
        c = sysb.coord.detach().requires_grad_(True)
        e = eb.pair_energy_binned(sysb.replace(coord=c), cutoff, term, ex, layout=layout)
        torch.autograd.grad(e.sum(), c)

    def d3_head() -> None:
        c = sysb.coord.detach().requires_grad_(True)
        e = eb.dftd3_binned(sysb.replace(coord=c), tables, d3.a1, d3.a2, d3.s8, d3.s6, r_on, d3.cutoff)
        torch.autograd.grad(e.sum(), c)

    res = {"prepare_s": t_prep, "prepare_reuse_s": t_reuse}
    for name, (term, cutoff, ex, layout) in terms.items():
        res[f"{name}_fwd_bwd_s"] = timed(lambda: sweep(term, cutoff, ex, layout))
    res["d3_head_fwd_bwd_s"] = timed(d3_head)
    log(f"[layers] prepare_system {t_prep * 1e3:.1f} ms built, {t_reuse * 1e3:.1f} ms reusing the "
        f"layout; pair sweeps forward + backward: "
        + ", ".join(f"{n} {res[f'{n}_fwd_bwd_s'] * 1e3:.1f} ms" for n in terms)
        + f"; the D3 head {res['d3_head_fwd_bwd_s'] * 1e3:.1f} ms (medians of 3)")
    return res


def energy_terms_abs(params, cfg, sysb) -> float:
    """The magnitude of the terms a configuration's energy sums on the
    system ``sysb`` (either layout; all molecules): the sum of |atomic
    energy| over the real atoms
    (the heads up to the atomic sum), plus |E - their sum| for the
    long-range heads.  Rounding each term once in f32 moves the energy by
    at most ``F32_EPS`` times this: the floor of an energy gate."""
    import torch

    from aimnetcentral_tpu_torch.models import aimnet2_apply
    from aimnetcentral_tpu_torch.models.heads import AtomicSumHead, auto_switch_simple_to_dsf

    if sysb.cell is not None:
        cfg = auto_switch_simple_to_dsf(cfg)
    k = next(i for i, (_n, h) in enumerate(cfg.outputs) if isinstance(h, AtomicSumHead))
    with torch.no_grad():
        e_atom = aimnet2_apply(params, dataclasses.replace(cfg, outputs=cfg.outputs[:k]), sysb,
                               sae_external=True)["energy"]
        e_total = aimnet2_apply(params, cfg, sysb, sae_external=True)["energy"]
    e_atom = e_atom.reshape(sysb.natoms, -1)[sysb.numbers > 0].double()
    return float(e_atom.abs().sum() + (e_total.double().sum() - e_atom.sum()).abs())


def phase_card_vs_cpu(label: str, params, cfg, n_box: int = CHECK_BOX) -> dict:
    """Energy, forces and stress on an ``n_box``-atom box on the binned
    layout (``CHECK_THRESHOLD``), the card against the port's CPU run.
    The energy gate is 1e-5 relative with an absolute floor of one f32
    rounding of every term the energy sums (``energy_terms_abs``): the
    random flagship's energy on this box is near zero (0.15 eV), below the
    f32 noise of the sum of its terms."""
    import torch

    from aimnetcentral_tpu_torch.calculators import AIMNet2Calculator
    from aimnetcentral_tpu_torch.models.bridge import params_to

    coord, numbers, cell = build_box(n_box, seed=1)
    data = {"coord": coord, "numbers": numbers, "cell": cell}
    calc = AIMNet2Calculator((params, cfg), device="cuda", binned_threshold=CHECK_THRESHOLD)
    sysb = calc.prepare_system(data)
    grid = sysb.lr_bins
    floor = F32_EPS * energy_terms_abs(params, cfg, sysb)
    t0 = time.perf_counter()
    card = calc.eval(data, forces=True, stress=True)
    torch.cuda.synchronize()
    t_card = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu = AIMNet2Calculator((params_to(params, torch.device("cpu")), cfg), device="cpu",
                            binned_threshold=CHECK_THRESHOLD).eval(data, forces=True, stress=True)
    t_cpu = time.perf_counter() - t0
    de = abs(float(card["energy"][0] - cpu["energy"][0]))
    df = float(np.abs(card["forces"] - cpu["forces"]).max())
    ds = float(np.abs(card["stress"] - cpu["stress"]).max())
    e_tol = max(REL_TOL * abs(float(cpu["energy"][0])), floor)
    log(f"[check {label}] {n_box} atoms, LR grid {grid.nbins} C={grid.capacity}: "
        f"E card {card['energy'][0]:.6f} cpu {cpu['energy'][0]:.6f} "
        f"|dE| {de:.3e} eV (limit {e_tol:.3e}: 1e-5 relative, floor {floor:.3e} = one f32 rounding of "
        f"the terms summed); max |dF| {df:.3e} eV/A; max |dstress| {ds:.3e} eV/A^3 "
        f"(card {t_card:.1f} s, cpu {t_cpu:.1f} s)")
    if de > e_tol or df > 1e-4 or ds > 1e-6:
        raise SystemExit(f"FAIL: the card and the CPU run disagree on {label}")
    return {"dE": de, "dE_limit": e_tol, "dE_floor": floor, "dF": df, "dstress": ds,
            "card_s": t_card, "cpu_s": t_cpu}


def over_limits(diffs: dict, limits: dict) -> list[str]:
    """The names of the differences above their absolute limits."""
    return [k for k, v in diffs.items() if v > limits[k]]


def phase_reuse(label: str, params, cfg) -> dict:
    """A calculator request after a sub-skin move reuses the prepared layout
    (no rebuild) and equals a fresh calculator's request within the absolute
    limits ``CHECK_ABS`` (energy, forces, stress).  The same request at the
    ``fast`` tier is the control: TF32 matmuls must come out beyond a limit,
    or the limits could not tell a wrong answer from f32 noise."""
    from aimnetcentral_tpu_torch.calculators import AIMNet2Calculator

    coord, numbers, cell = build_box(N_CHECK, seed=1)
    step = np.random.default_rng(3).normal(scale=0.05, size=coord.shape)
    moved = {"coord": (coord + np.clip(step, -0.25, 0.25)).astype(np.float32), "numbers": numbers, "cell": cell}
    ref = AIMNet2Calculator((params, cfg), device="cuda").eval(moved, forces=True, stress=True)
    res = {}
    for tier in ("exact", "fast"):
        calc = AIMNet2Calculator((params, cfg), device="cuda", precision=tier)
        calc.eval({"coord": coord, "numbers": numbers, "cell": cell})
        cached = calc._prep_cache["system"]
        got = calc.eval(moved, forces=True, stress=True)
        if calc._prep_cache["system"] is not cached:
            raise SystemExit("FAIL: a sub-skin move rebuilt the calculator's layout")
        res[tier] = {
            "energy": abs(float(got["energy"][0] - ref["energy"][0])),
            "forces": float(np.abs(got["forces"] - ref["forces"]).max()),
            "stress": float(np.abs(got["stress"] - ref["stress"]).max()),
        }
        log(f"[reuse {label} {tier}] {N_CHECK} atoms moved by at most 0.25 A: the layout was reused; against a "
            f"fresh calculator at exact |dE| {res[tier]['energy']:.3e} eV, max |dF| {res[tier]['forces']:.3e} "
            f"eV/A, max |dstress| {res[tier]['stress']:.3e} eV/A^3 (limits {CHECK_ABS['energy']:.1e}, "
            f"{CHECK_ABS['forces']:.1e}, {CHECK_ABS['stress']:.1e})")
    if over_limits(res["exact"], CHECK_ABS):
        raise SystemExit(f"FAIL: the reused layout and a fresh build disagree on {label}: "
                         f"{over_limits(res['exact'], CHECK_ABS)}")
    if not over_limits(res["fast"], CHECK_ABS):
        raise SystemExit(f"FAIL: the fast-tier control passed the reuse limits on {label}: they cannot see TF32")
    return res


def lr_shape(sysb) -> tuple:
    """What fixes kernels D and E's launch shapes on a binned system's LR
    layout: its grid, capacity and stencil radius at the LR cutoff."""
    from aimnetcentral_tpu_torch.ops.binned import stencil_radius

    g = sysb.lr_bins
    return g.nbins, g.capacity, stencil_radius(LR_CUTOFF, g)


def md_system(coord, numbers, cell, device):
    """The compact System an MD driver starts from."""
    from aimnetcentral_tpu_torch.builders import system_from_molecules
    from aimnetcentral_tpu_torch.calculators.calculator import ATOM_BUCKET

    n_pad = -(-(len(numbers) + 1) // ATOM_BUCKET) * ATOM_BUCKET
    return system_from_molecules([{"coord": coord, "numbers": numbers, "cell": cell}], device, n_pad=n_pad)


def dev_us(e) -> float:
    """A profiler event's own device time (us); the attribute was renamed
    across torch versions."""
    return float(getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0.0)))


def on_device(e) -> bool:
    """Whether a profiler event is on the device's timeline."""
    return str(getattr(e, "device_type", "")).endswith("CUDA")


def device_busy_ms(prof, spans: tuple = ()) -> float:
    """Device time of a profile's kernel-level events (ms), leaving out the
    device side of the ``record_function`` spans named in ``spans``."""
    return sum(dev_us(e) for e in prof.key_averages() if on_device(e) and e.key not in spans) / 1e3


def md_window(label: str, drv, per_eval: dict, request_peak: int | None, n_chunks: int = MD_TIMED,
              chunk: int = MD_CHUNK) -> dict:
    """``n_chunks`` chunks of ``chunk`` steps with every kernel's launches
    counted around them, then one profiled chunk.  The peak memory is gated
    against ``request_peak`` (a single request's) when one is given.  The step time is the
    window's whole wall time over its steps (host clock ending in a
    synchronize), the chunks' spread beside it.  The total energy
    (potential plus kinetic) is read from the observables; a window whose
    box ran hotter than ten times the target temperature is marked as not
    representative of MD on a sane potential."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from aimnetcentral_tpu_torch import constants

    n_real = int((drv.state.system.numbers > 0).sum())

    wrappers = counters()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held0 = torch.cuda.memory_allocated()
    rebins0, regrows0 = drv.rebins, drv.regrows
    for fn in wrappers.values():
        fn.launches = 0
    chunk_s, temps, etot = [], [], []
    t_start = time.perf_counter()
    for _ in range(n_chunks):
        t0 = time.perf_counter()
        obs = drv.run(chunk, chunk=chunk)
        torch.cuda.synchronize()
        chunk_s.append(time.perf_counter() - t0)
        if not all(np.isfinite(v).all() for v in obs.values()):
            raise SystemExit(f"FAIL: non-finite MD observables on {label}")
        temps.append(float(obs["temperature"].mean()))
        etot += list(obs["epot"].astype(np.float64) + 1.5 * n_real * constants.kB * obs["temperature"])
    total_s = time.perf_counter() - t_start
    launches = {name: fn.launches for name, fn in wrappers.items()}
    steps = n_chunks * chunk
    rebins, regrows = drv.rebins - rebins0, drv.regrows - regrows0
    evals = steps + chunk * regrows  # a retried chunk evaluates its steps again
    for name, n in launches.items():
        if n != per_eval[name] * evals:
            raise SystemExit(f"FAIL: {name} launched {n} times in {evals} MD force evaluations on {label}, "
                             f"expected {per_eval[name]} each ({rebins} re-binning steps)")
    peak = torch.cuda.max_memory_allocated()
    held = torch.cuda.memory_allocated() - held0
    per_step = [t / chunk * 1e3 for t in chunk_s]
    ms = total_s / steps * 1e3
    drift = abs(etot[-1] - etot[0]) / abs(etot[0])
    hot = max(temps) > 10 * drv.md.temperature_K
    note = (f"; HOT BOX (up to {max(temps):.3g} K, {rebins * 100 / steps:.0f} re-binnings per 100 steps): "
            f"not representative of MD on a sane potential" if hot else "")
    log(f"[md {label}] {steps} steps in {total_s:.3f} s: {ms:.2f} ms a step ({1e3 / ms:.2f} steps/s; chunks of "
        f"{chunk}: {', '.join(f'{t:.2f}' for t in per_step)} ms a step, median {np.median(per_step):.2f}, min "
        f"{min(per_step):.2f}, max {max(per_step):.2f}); {rebins * 100 / steps:.1f} "
        f"re-binnings per 100 steps, {regrows} retried chunks; peak memory {peak / 2**30:.3f} GiB"
        + (f" (a single request: {request_peak / 2**30:.3f})" if request_peak is not None else "")
        + f", held {held / 2**20:+.1f} MiB; mean temperature by "
        f"chunk {', '.join(f'{t:.0f}' for t in temps)} K; total energy {etot[0]:.4f} -> {etot[-1]:.4f} eV "
        f"(|change| / |E| {drift:.2e}); launches {launches}{note}")
    if request_peak is not None and peak > MD_PEAK_RATIO * request_peak:
        raise SystemExit(f"FAIL: MD peak memory {peak} B above {MD_PEAK_RATIO} x the single request's on {label}")
    if held > MD_HELD_GROWTH:
        raise SystemExit(f"FAIL: MD holds {held} B more after the window than before on {label}")

    # one more chunk under the profiler: device busy against the unprofiled
    # step time (the profiler slows the host)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        drv.run(chunk, chunk=chunk)
        torch.cuda.synchronize()
    busy = device_busy_ms(prof) / chunk
    idle = max(0.0, 1 - busy / ms)
    top = sorted((e for e in prof.key_averages() if str(getattr(e, "device_type", "")).endswith("CUDA")),
                 key=dev_us, reverse=True)[:3]
    log(f"[md {label}] profiled chunk: device busy {busy:.2f} ms a step, idle share against the "
        f"unprofiled step time {idle:.3f}; most device time a step: "
        + "; ".join(f"{dev_us(e) / 1e3 / chunk:.2f} ms {e.key[:60]}" for e in top))
    return {
        "total_s": total_s, "ms_per_step": ms, "steps_per_s": 1e3 / ms, "chunk_ms_per_step": per_step,
        "hot": hot, "rebins_per_100": rebins * 100 / steps, "retried_chunks": regrows, "peak_bytes": peak,
        "held_growth_bytes": held, "device_busy_ms_per_step": busy, "idle_share": idle,
        "launches": launches, "launches_per_step": {k: v / evals for k, v in launches.items()},
        "mean_temperature_K": temps, "etot_first_last_eV": (etot[0], etot[-1]), "etot_drift": drift,
    }


def phase_md(params, cfg, params_d3, cfg_d3, coord, numbers, cell, request_peaks: dict) -> dict:
    """MD on both configurations at the main path's size, and two drivers of
    one seed repeating each other bit for bit."""
    import torch

    from aimnetcentral_tpu_torch.dynamics import MDConfig, MDDriver

    dev = torch.device("cuda")
    md = MDConfig(**MD_SETTING)
    system = md_system(coord, numbers, cell, dev)
    conv = {"conv_stencil_forward": 3, "conv_stencil_backward": 3}
    windows = {}
    for label, p, c, n_pair, tiers in (
        ("flagship-10k", params, cfg, 1, (None, "exact")),
        ("wb97m-d3-10k", params_d3, cfg_d3, 3, (None,)),
    ):
        t0 = time.perf_counter()
        drv = MDDriver(p, c, system, md, seed=0, device="cuda")
        warm = drv.run(MD_WARM * MD_CHUNK, chunk=MD_CHUNK)
        torch.cuda.synchronize()
        log(f"[md {label}] SR grid {drv.grid.nbins} C={drv.grid.capacity}, LR grid {drv.lr_grid.nbins} "
            f"C={drv.lr_grid.capacity}; warm-up {MD_WARM * MD_CHUNK} steps in {time.perf_counter() - t0:.1f} s "
            f"(driver, initial forces, steps), temperature {warm['temperature'][0]:.0f} -> "
            f"{warm['temperature'][-1]:.0f} K, {drv.regrows} retried chunks")
        per_eval = {**conv, "pair_sweep_forward": n_pair, "pair_sweep_backward": n_pair}
        for tier in tiers:
            drv.md = dataclasses.replace(md, precision=tier)
            name = f"{label} {tier or 'fast'}"
            windows[name] = md_window(name, drv, per_eval, request_peaks[label])
        del drv
        # the random-weight potential is unbounded below: atoms fall
        # together and after 35-40 fs (steps 70-80 at 0.5 fs) the forces
        # of colliding atoms blow the box up, so the windows above run
        # hot, re-binning every step.  The first 50 steps of a fresh NVE
        # driver are the regime of a sane potential: timed, and at the
        # exact tier gated on energy conservation
        for tier in tiers:
            name = f"{label} {tier or 'fast'} first 50 NVE"
            drv = MDDriver(p, c, system, dataclasses.replace(md, thermostat="nve", precision=tier), seed=0,
                           device="cuda")
            drv.state  # the initial forces, outside the window
            windows[name] = md_window(name, drv, per_eval, request_peaks[label], n_chunks=MD_WARM)
            if tier == "exact" and windows[name]["etot_drift"] > MD_NVE_DRIFT:
                raise SystemExit(f"FAIL: NVE total energy moved by more than {MD_NVE_DRIFT} of itself on {name}")
            del drv
        torch.cuda.empty_cache()

    snaps = []
    for _ in range(2):
        drv = MDDriver(params, cfg, system, md, seed=7, device="cuda")
        drv.run(2 * MD_CHUNK, chunk=MD_CHUNK)
        snaps.append(drv.snapshot())
    if not all(np.array_equal(snaps[0][k], snaps[1][k]) for k in ("coord", "veloc", "cell")):
        raise SystemExit("FAIL: two MD drivers of one seed gave other coordinates after 50 steps")
    log("[md] two drivers of one seed give the same coordinates and velocities bit for bit after 50 steps")
    return {"windows": windows}


def md_trace(drv, n_steps: int, n_atoms: int = N_CHECK) -> dict:
    """``n_steps`` MD steps one chunk each: the potential energy (and an
    ensemble's ``epot_std``) and the forces (caller atom order) after every
    step, and the final frame."""
    epot, epot_std, forces = [], [], []
    for _ in range(n_steps):
        obs = drv.run(1, chunk=1)
        epot.append(float(obs["epot"][0]))
        epot_std.append(float(obs.get("epot_std", np.zeros(1))[0]))
        st = drv.state
        real = st.system.numbers > 0
        f = np.zeros((n_atoms, 3), np.float32)
        f[st.atom_id[real].cpu().numpy()] = st.forces[real].cpu().numpy()
        forces.append(f)
    return {"epot": np.array(epot), "epot_std": np.array(epot_std), "forces": np.stack(forces),
            "coord": drv.snapshot()["coord"][:n_atoms], "rebins": drv.rebins}


def phase_md_card_vs_cpu(label: str, params, cfg, mol: dict | None = None, ensemble: bool = False,
                         n_box: int = CHECK_BOX, steps: int = MD_CHECK_STEPS) -> dict:
    """On an ``n_box``-atom box (500): ``steps`` NVE steps from the same
    injected 300 K velocities at the exact tier, and as many FIRE steps, on the
    card and on the CPU, each with one re-bin (or, indexed, one rebuild of
    the lists) in its first step (``MD_CHECK_LAG``; a run without one
    fails).  Per step, the
    potential energy and every force are held to the absolute limits
    ``CHECK_ABS``, and the final coordinates of both runs too; the same
    steps on the card at the ``fast`` tier are the control, which must come
    out beyond a limit (CPU matmuls are exact f32 at every tier).  With a
    gas-phase molecule ``mol`` the same MD check runs on it (the indexed
    engine), without FIRE.  With ``ensemble`` (stacked members, the fused
    forward) the members' ``epot_std`` is held to the energy's limit too,
    without FIRE."""
    import torch

    from aimnetcentral_tpu_torch import constants
    from aimnetcentral_tpu_torch.dynamics import MDConfig, MDDriver, fire_relax
    from aimnetcentral_tpu_torch.models.bridge import params_to
    from aimnetcentral_tpu_torch.models.heads import auto_switch_simple_to_dsf
    from aimnetcentral_tpu_torch.ops import binned as B

    if mol is None:
        coord, numbers, cell = build_box(n_box, seed=1)
    else:
        coord, numbers, cell = mol["coord"], mol["numbers"], None
    n = len(numbers)
    fire = mol is None and not ensemble
    masses = constants.get_masses()[numbers]
    v0 = np.sqrt(constants.kB * 300.0 / masses)[:, None] * np.random.default_rng(5).normal(size=(n, 3))
    runs = {}
    for key, dev, tier in (("card", "cuda", "exact"), ("card fast", "cuda", "fast"), ("cpu", "cpu", "exact")):
        dev = torch.device(dev)
        t0 = time.perf_counter()
        p = params_to(params, dev)
        system = md_system(coord, numbers, cell, dev)
        drv = MDDriver(p, cfg, system, MDConfig(dt_fs=0.5, thermostat="nve", skin=0.3, precision=tier),
                       ensemble=ensemble, device=dev)
        st = drv._state
        vel = torch.as_tensor(v0.astype(np.float32), device=dev)
        real = (st.system.numbers > 0)[:, None]
        # the last re-bin's reference positions put 0.49 skin behind in x:
        # the first step carries atoms past skin / 2, so every run re-bins
        # (binned) or rebuilds its lists (indexed) inside the compared steps
        lag = torch.tensor([MD_CHECK_LAG * drv.md.skin, 0.0, 0.0], device=dev)
        drv._state = dataclasses.replace(
            st, veloc=torch.where(real, vel[st.atom_id.clamp(max=n - 1)], 0.0),
            ref_coord=torch.where(real, st.ref_coord - lag, st.ref_coord),
        )
        runs[key] = md_trace(drv, steps, n)
        if tier == "exact" and fire:
            # FIRE on a fixed binned layout of the same box
            grid = dataclasses.replace(B.plan_bins(cell, n_box, cfg.aev.rc_s + 0.3), margin=0.3)
            lr_grid = B.plan_lr_bins(cell, n_box, drv._lr_cutoff(), margin=0.3)
            sysb, _perm, ovf = B.to_binned_system(system, grid, lr_grid)
            if bool(ovf.any()):
                raise SystemExit("FAIL: the FIRE layout overflowed")
            relaxed, info = fire_relax(p, auto_switch_simple_to_dsf(cfg), sysb, fmax=0.0, max_steps=steps)
            real = sysb.numbers > 0
            runs[key].update(fire=relaxed.coord[real].cpu().numpy(), fire_fmax=info["fmax"])
        runs[key]["s"] = time.perf_counter() - t0
    cpu = runs["cpu"]
    diffs = {}
    for key in ("card", "card fast"):
        run = runs[key]
        diffs[key] = {
            "energy": float(np.abs(run["epot"] - cpu["epot"]).max()),
            "forces": float(np.abs(run["forces"] - cpu["forces"]).max()),
            "coord": float(np.abs(run["coord"] - cpu["coord"]).max()),
        }
        if ensemble:
            diffs[key]["epot_std"] = float(np.abs(run["epot_std"] - cpu["epot_std"]).max())
        d = diffs[key]
        log(f"[md check {label} {key}] {n} atoms, {drv.engine} engine, {steps} NVE steps "
            f"({run['rebins']} rebuilds; "
            f"{cpu['rebins']} on the CPU), against the CPU at exact: largest per-step |dE| {d['energy']:.3e} eV "
            f"({d['energy'] / np.abs(cpu['epot']).min():.2e} relative), largest per-step |dF| {d['forces']:.3e} "
            f"eV/A, final max |dx| {d['coord']:.3e} A"
            + (f", largest per-step |d epot_std| {d['epot_std']:.3e} eV (epot_std {cpu['epot_std'].max():.4e})"
               if ensemble else "")
            + f" (limits {CHECK_ABS['energy']:.1e}, "
            f"{CHECK_ABS['forces']:.1e}, {CHECK_ABS['coord']:.1e}; card {run['s']:.1f} s, cpu {cpu['s']:.1f} s)")
    dfire = 0.0
    if fire:
        dfire = float(np.abs(runs["card"]["fire"] - cpu["fire"]).max())
        log(f"[md check {label}] {steps} FIRE steps: max |dx| {dfire:.3e} A (limit {CHECK_ABS['coord']:.1e}), fmax "
            f"{runs['card']['fire_fmax']:.4f} / {cpu['fire_fmax']:.4f} eV/A")
    rebins = {key: run["rebins"] for key, run in runs.items()}
    if min(rebins.values()) < 1:
        raise SystemExit(f"FAIL: the MD check on {label} compared no re-bin: {rebins}")
    limits = {k: CHECK_ABS[k] for k in ("energy", "forces", "coord")}
    if ensemble:
        limits["epot_std"] = CHECK_ABS["energy"]
    if over_limits(diffs["card"], limits) or dfire > CHECK_ABS["coord"]:
        raise SystemExit(f"FAIL: MD or FIRE on the card and on the CPU disagree on {label}: "
                         f"{over_limits(diffs['card'], limits)}, FIRE {dfire:.3e} A")
    if not over_limits({k: diffs["card fast"][k] for k in ("energy", "forces")}, limits):
        raise SystemExit(f"FAIL: the fast-tier MD control passed the limits on {label}: they cannot see TF32")
    return {"diffs": diffs, "fire_coord_A": dfire, "rebins": rebins, "card_s": runs["card"]["s"], "cpu_s": cpu["s"]}


def gas_cluster(n_atoms: int, seed: int = 0) -> dict:
    """A gas-phase cluster: the ``n_atoms`` atoms of a ``build_box`` box (of
    twice as many atoms) nearest its centre, their numbers kept."""
    coord, numbers, cell = build_box(2 * n_atoms + 64, seed=seed)
    keep = np.argsort(np.linalg.norm(coord - np.diag(cell) / 2, axis=1), kind="stable")[:n_atoms]
    return {"coord": coord[keep], "numbers": numbers[keep]}


def dsf_config(cfg):
    """``cfg`` with its Coulomb head's method set to DSF."""
    from aimnetcentral_tpu_torch.models.heads import LRCoulombHead

    return dataclasses.replace(cfg, outputs=tuple(
        (n, dataclasses.replace(h, method="dsf") if isinstance(h, LRCoulombHead) else h) for n, h in cfg.outputs
    ))


def d3_cutoff_config(cfg, cutoff: float):
    """``cfg`` with its D3 head's cutoff set to ``cutoff``."""
    from aimnetcentral_tpu_torch.models.heads import DFTD3Head

    return dataclasses.replace(cfg, outputs=tuple(
        (n, dataclasses.replace(h, cutoff=cutoff) if isinstance(h, DFTD3Head) else h) for n, h in cfg.outputs
    ))


def nudged(data, rng, scale: float = 0.02):
    """``data`` (one structure or a list) with every coordinate moved by a
    normal draw of ``scale`` A: well inside the calculator's reuse skin."""
    if isinstance(data, list):
        return [nudged(m, rng, scale) for m in data]
    return {**data, "coord": (data["coord"] + rng.normal(scale=scale, size=data["coord"].shape)).astype(np.float32)}


def gas_request(label: str, calc, data, stress: bool, per_request: dict, n_built: int = N_TIMED) -> dict:
    """Two requests on ``data`` with every kernel's launches counted around
    them (the second reuses the layout and must repeat the first bit for
    bit), then ``N_TIMED`` timed reusing the layout and ``n_built`` each
    building it, cycling over three inputs; peak device memory of the
    first two."""
    import torch

    rng = np.random.default_rng(6)
    inputs = [data] + [nudged(data, rng) for _ in range(2)]
    wrappers = counters()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in wrappers.values():
        fn.launches = 0
    t0 = time.perf_counter()
    first = calc.eval(data, forces=True, stress=stress)
    torch.cuda.synchronize()
    t_first = time.perf_counter() - t0
    layout = calc._prep_cache["system"]
    again = calc.eval(data, forces=True, stress=stress)
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in wrappers.items()}
    peak = torch.cuda.max_memory_allocated()
    if calc._prep_cache["system"] is not layout:
        raise SystemExit(f"FAIL: a repeated request rebuilt the layout on {label}")
    for key in first:
        if not np.array_equal(first[key], again[key]):
            raise SystemExit(f"FAIL: a repeated request gave another {key} on {label}")
    for name, n in launches.items():
        if n != 2 * per_request[name]:
            raise SystemExit(f"FAIL: {name} launched {n} times in two requests on {label}, expected "
                             f"{per_request[name]} each")
    sizes = [len(m["numbers"]) for m in data] if isinstance(data, list) else [len(data["numbers"])]
    e, f_ = first["energy"], first["forces"]
    if e.shape != (len(sizes),) or f_.shape != (sum(sizes), 3) or not (np.isfinite(e).all() and np.isfinite(f_).all()):
        raise SystemExit(f"FAIL: energy {e.shape} or forces {f_.shape} wrong or not finite on {label}")
    if stress and (first["stress"].shape != (1, 3, 3) or not np.isfinite(first["stress"]).all()):
        raise SystemExit(f"FAIL: stress wrong or not finite on {label}")
    for k, start in enumerate(np.cumsum([0] + sizes[:-1])):
        fm = f_[start : start + sizes[k]].astype(np.float64)
        if np.abs(fm.sum(0)).max() > 1e-5 * np.abs(fm).sum():
            raise SystemExit(f"FAIL: net force on molecule {k} of {label}")
    reused, built = [], []
    for k in range(N_TIMED):
        t0 = time.perf_counter()
        calc.eval(inputs[k % 3], forces=True, stress=stress)
        torch.cuda.synchronize()
        reused.append(time.perf_counter() - t0)
        if calc._prep_cache["system"] is not layout:
            raise SystemExit(f"FAIL: a sub-skin move rebuilt the layout on {label}")
    for k in range(n_built):
        calc._prep_cache = None
        t0 = time.perf_counter()
        calc.eval(inputs[k % 3], forces=True, stress=stress)
        torch.cuda.synchronize()
        built.append(time.perf_counter() - t0)
    # one more request under the profiler: device busy against the
    # unprofiled median, the kernels that take the device time, and the
    # host's spans: the species check, the layout, the pair sweeps'
    # operands and the copies back, each a record_function around the
    # outermost call (inclusive host time under the profiler; the species
    # check calls itself once a molecule)
    from torch.profiler import ProfilerActivity, profile, record_function

    from aimnetcentral_tpu_torch.models import engine_binned as eb

    def spanned(name, fn):
        depth = [0]

        def run(*args, **kwargs):
            if depth[0]:
                return fn(*args, **kwargs)
            depth[0] += 1
            try:
                with record_function(name):
                    return fn(*args, **kwargs)
            finally:
                depth[0] -= 1
        return run

    spans = {"species check": "_validate_species_and_charge", "prepare": "prepare_system",
             "postprocess": "_postprocess"}
    for name, attr in spans.items():
        setattr(calc, attr, spanned(name, getattr(calc, attr)))
    operands = eb.pair_operands
    eb.pair_operands = spanned("pair operands", operands)
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            calc.eval(data, forces=True, stress=stress)
            torch.cuda.synchronize()
            profiled_ms = (time.perf_counter() - t0) * 1e3
    finally:
        eb.pair_operands = operands
        for attr in spans.values():
            delattr(calc, attr)
    names = (*spans, "pair operands")
    busy = device_busy_ms(prof, names)
    events = prof.key_averages()
    host = {e.key: (e.cpu_time_total / 1e3, e.count) for e in events if e.key in names and not on_device(e)}
    host_launches = sum(e.count for e in events if e.key in ("cudaLaunchKernel", "cuLaunchKernel",
                                                              "cudaLaunchKernelExC"))
    idle = max(0.0, 1 - busy / (np.median(reused) * 1e3))
    top = sorted((e for e in events if on_device(e) and e.key not in names), key=dev_us, reverse=True)[:5]
    kind = calc._prep_cache["kind"]
    if kind == "indexed":
        lists = [s for s in ("", "_lr", "_coulomb", "_dftd3") if getattr(layout, f"nbmat{s}") is not None]
        shape = "lists " + ", ".join(f"nbmat{s} {tuple(getattr(layout, f'nbmat{s}').shape)}" for s in lists)
    else:
        shape = f"grid {layout.bins.nbins} C={layout.bins.capacity}"
        if layout.lr_bins is not None:
            shape += f", LR grid {layout.lr_bins.nbins} C={layout.lr_bins.capacity}"
    log(f"[gas {label}] {len(sizes)} molecule(s), {sum(sizes)} atoms, {kind} layout ({shape}); E[0] = {e[0]:.6f} eV; "
        f"first request {t_first * 1e3:.1f} ms; {N_TIMED} reusing the layout: median {np.median(reused) * 1e3:.2f} ms "
        f"(min {min(reused) * 1e3:.2f}, max {max(reused) * 1e3:.2f}); {n_built} building it: median "
        f"{np.median(built) * 1e3:.2f} ms (min {min(built) * 1e3:.2f}, max {max(built) * 1e3:.2f}); peak memory "
        f"{peak / 2**30:.3f} GiB; launches per request {({k: v // 2 for k, v in launches.items()})}; a repeated "
        f"request gives the same results bit for bit")
    log(f"[gas {label}] profiled request: device busy {busy:.2f} ms, idle share against the unprofiled median "
        f"{idle:.3f}; most device time: " + "; ".join(f"{dev_us(e) / 1e3:.2f} ms x{e.count} {e.key[:60]}" for e in top))
    log(f"[gas {label}] profiled request's host: {profiled_ms:.2f} ms wall, {host_launches} kernel launches; "
        + "; ".join(f"{k} {ms:.2f} ms x{n}" for k, (ms, n) in host.items()))
    return {"layout": kind, "atoms": sum(sizes), "molecules": len(sizes), "launches": launches,
            "device_busy_ms": busy, "idle_share": idle, "profiled_ms": profiled_ms,
            "host_spans_ms": {k: ms for k, (ms, _n) in host.items()}, "host_launches": host_launches,
            "top": [{"name": e.key[:90], "ms": dev_us(e) / 1e3, "count": e.count} for e in top],
            "first_s": t_first, "reused_s": reused, "reused_median_s": float(np.median(reused)),
            "built_s": built, "built_median_s": float(np.median(built)), "peak_bytes": peak}


def gas_card_vs_cpu(label: str, params, cfg, data, stress: bool, binned_threshold: int = 1024) -> dict:
    """One request on the card against the port's CPU run: per-molecule
    energy within 1e-5 relative with the floor of one f32 rounding of every
    summed term, forces 1e-4 eV/A, stress 1e-6 eV/A^3."""
    import torch

    from aimnetcentral_tpu_torch.calculators import AIMNet2Calculator
    from aimnetcentral_tpu_torch.models.bridge import params_to

    calc = AIMNet2Calculator((params, cfg), device="cuda", binned_threshold=binned_threshold)
    system = calc.prepare_system(data)
    floor = F32_EPS * energy_terms_abs(params, cfg, system)
    t0 = time.perf_counter()
    card = calc.eval(data, forces=True, stress=stress)
    torch.cuda.synchronize()
    t_card = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu = AIMNet2Calculator((params_to(params, torch.device("cpu")), cfg), device="cpu",
                            binned_threshold=binned_threshold).eval(data, forces=True, stress=stress)
    t_cpu = time.perf_counter() - t0
    de = np.abs(card["energy"] - cpu["energy"])
    e_tol = np.maximum(REL_TOL * np.abs(cpu["energy"]), floor)
    df = float(np.abs(card["forces"] - cpu["forces"]).max())
    ds = float(np.abs(card["stress"] - cpu["stress"]).max()) if stress else 0.0
    log(f"[gas check {label}] {calc._prep_cache['kind']} layout, "
        f"{len(card['forces'])} atoms: largest |dE| {de.max():.3e} eV (limit {e_tol.min():.3e}: 1e-5 relative, floor "
        f"{floor:.3e}); max |dF| {df:.3e} eV/A" + (f"; max |dstress| {ds:.3e} eV/A^3" if stress else "")
        + f" (card {t_card:.2f} s, cpu {t_cpu:.2f} s)")
    if (de > e_tol).any() or df > 1e-4 or ds > 1e-6:
        raise SystemExit(f"FAIL: the card and the CPU run disagree on {label}")
    return {"dE": float(de.max()), "dE_limit": float(e_tol.min()), "dF": df, "dstress": ds,
            "card_s": t_card, "cpu_s": t_cpu}


GAS_BATCH = (40, 57, 74, 91, 108, 120, 65, 83)  # batch-8: 638 atoms


def phase_gas(params, cfg, params_d3, cfg_d3) -> dict:
    """Molecules, batches, small boxes and gas-phase clusters through
    ``AIMNet2Calculator.eval(forces=True)`` at full width (clusters cut from
    ``build_box`` geometry): mol-113 (flagship and wb97m-d3: the indexed
    all-pairs layout), batch-8 (eight clusters of 40-120 atoms as a list),
    periodic-500 (wb97m-d3 with stress: shifts, DSF by the periodic switch,
    one LR list shared by Coulomb and D3 at 15 A), periodic-500-split (its
    D3 cutoff at 8 A: a Coulomb and a D3 list, as the 1.2 ratio rule splits
    them),
    cluster-2000 (the largest all-pairs SR list, for its memory),
    cluster-3000 (the host cell list's cutoff-bounded SR list and the
    all-pairs LR list of simple Coulomb) and cluster-10k-dsf (the flagship
    with DSF Coulomb: the gas-phase binned grid).  Each: launches (none on
    the indexed layout; A, B 3 and D, E 1 a request on the grid), a bitwise
    repeat, request times built and reused, peak memory.  Kernels A, B, D
    and E against their plain versions on the 10k gas-phase grid, and the
    card against the CPU on mol-113, batch-8, periodic-500 (both) and a
    500-atom DSF cluster on its gas-phase grid (``CHECK_THRESHOLD``)."""
    from aimnetcentral_tpu_torch.calculators import AIMNet2Calculator

    cfg_dsf = dsf_config(cfg)
    cfg_split = d3_cutoff_config(cfg_d3, 8.0)
    mol = gas_cluster(113, seed=1)
    batch = [gas_cluster(n, seed=10 + k) for k, n in enumerate(GAS_BATCH)]
    coord, numbers, cell = build_box(500, seed=2)
    box = {"coord": coord, "numbers": numbers, "cell": cell}
    none = {name: 0 for name in counters()}
    grid = {"conv_stencil_forward": 3, "conv_stencil_backward": 3, "pair_sweep_forward": 1,
            "pair_sweep_backward": 1}
    cases = (
        ("mol-113 flagship", params, cfg, mol, False, none),
        ("mol-113 wb97m-d3", params_d3, cfg_d3, mol, False, none),
        ("batch-8 flagship", params, cfg, batch, False, none),
        ("periodic-500 wb97m-d3", params_d3, cfg_d3, box, True, none),
        ("periodic-500-split wb97m-d3", params_d3, cfg_split, box, True, none),
        ("cluster-2000 flagship", params, cfg, gas_cluster(2000, seed=4), False, none),
        ("cluster-3000 flagship", params, cfg, gas_cluster(3000, seed=3), False, none),
        ("cluster-10k-dsf flagship", params, cfg_dsf, gas_cluster(N_MAIN, seed=5), False, grid),
    )
    res: dict = {"requests": {}, "checks": {}}
    launches = dict(none)
    for label, p, c, data, stress, per_request in cases:
        calc = AIMNet2Calculator((p, c), device="cuda")
        res["requests"][label] = gas_request(label, calc, data, stress, per_request, N_BUILT_GAS)
        if label.startswith("periodic-500"):
            system = calc._prep_cache["system"]
            split = "split" in label
            if (system.nbmat_lr is None) != split or (system.nbmat_dftd3 is not None) != split:
                raise SystemExit(f"FAIL: {label} ran {'shared' if split else 'split'} long-range lists")
        for name, n in res["requests"][label]["launches"].items():
            launches[name] += n
        if per_request is grid:
            sysb = calc.prepare_system(data)
            _rows, res["kernels_detail"] = phase_kernels(calc, sysb, "gas 10k")
            _rows, res["pair_kernels_detail"] = phase_pair_kernels(calc, sysb, "gas 10k")
        del calc
    res["launches"] = launches
    for label, p, c, data, stress, threshold in (
        ("mol-113 flagship", params, cfg, mol, False, 1024),
        ("mol-113 wb97m-d3", params_d3, cfg_d3, mol, False, 1024),
        ("batch-8 flagship", params, cfg, batch, False, 1024),
        ("periodic-500 wb97m-d3", params_d3, cfg_d3, box, True, 1024),
        ("periodic-500-split wb97m-d3", params_d3, cfg_split, box, True, 1024),
        (f"cluster-{CHECK_BOX}-dsf flagship", params, cfg_dsf, gas_cluster(CHECK_BOX, seed=5), False,
         CHECK_THRESHOLD),
    ):
        res["checks"][label] = gas_card_vs_cpu(label, p, c, data, stress, threshold)
    return res


PACKED_SIZES_SEED = 7  # packed-64: 64 clusters of 40-120 atoms, one of 120 (capacity 120)


def moved_batch(mols: list[dict], scale: float, seed: int = 12) -> list[dict]:
    """Every atom of every molecule moved by ``scale`` A in a random
    direction."""
    rng = np.random.default_rng(seed)
    out = []
    for m in mols:
        step = rng.normal(size=m["coord"].shape)
        step *= scale / np.linalg.norm(step, axis=1, keepdims=True)
        out.append({**m, "coord": (m["coord"] + step).astype(np.float32)})
    return out


def agree(label: str, got: dict, ref: dict, floor: float) -> dict:
    """Per-molecule energies within 1e-5 relative (with the f32 floor) and
    forces within 1e-4 eV/A of ``ref``."""
    de = np.abs(got["energy"] - ref["energy"])
    e_tol = np.maximum(REL_TOL * np.abs(ref["energy"]), floor)
    df = float(np.abs(got["forces"] - ref["forces"]).max())
    log(f"[packed {label}] largest |dE| {de.max():.3e} eV (limit {e_tol.min():.3e}: 1e-5 relative, floor "
        f"{floor:.3e}); max |dF| {df:.3e} eV/A (limit 1e-4)")
    if (de > e_tol).any() or df > 1e-4:
        raise SystemExit(f"FAIL: {label} disagree")
    return {"dE": float(de.max()), "dE_limit": float(e_tol.min()), "dF": df}


def phase_packed(params, cfg, params_d3, cfg_d3) -> dict:
    """Gas-phase batches at or above ``binned_threshold`` through
    ``AIMNet2Calculator.eval(forces=True)`` on the molecule-bin layout (one
    molecule a bin, capacity 120, every sweep at radius 0): packed-64 (the
    flagship: 64 clusters of 40-120 atoms cut from ``build_box`` geometry as
    batch-8's are; simple Coulomb through kernels D and E at cutoff inf) and
    packed-32x113 (wb97m-d3: 32 clusters of 113 atoms; D and E three times
    a request).  Each: launches (A, B 3; D, E 1 or 3 a request), a bitwise
    repeat, times reused and built, peak memory and a profiled request (as
    ``gas_request``); A, B (packed-64) and D, E against their plain versions
    on the layout with the f64 and row-by-row pair-count gates; the packed
    answer against the same batch on the card's indexed layout, whose
    request times are printed beside it; the layout kept after a 2 A move
    of every atom, its answer a fresh build's bit for bit.  Then the card
    against the CPU on an 8-molecule packed batch (batch-8's clusters,
    ``binned_threshold`` 512), both configurations."""
    import torch

    from aimnetcentral_tpu_torch.calculators import AIMNet2Calculator

    sizes = [120] + [int(n) for n in np.random.default_rng(PACKED_SIZES_SEED).integers(40, 121, size=63)]
    batch64 = [gas_cluster(n, seed=100 + k) for k, n in enumerate(sizes)]
    batch32 = [gas_cluster(113, seed=200 + k) for k in range(32)]
    conv = {"conv_stencil_forward": 3, "conv_stencil_backward": 3}
    none = {name: 0 for name in counters()}
    cases = (
        ("packed-64 flagship", params, cfg, batch64, {**conv, "pair_sweep_forward": 1, "pair_sweep_backward": 1}),
        ("packed-32x113 wb97m-d3", params_d3, cfg_d3, batch32,
         {**conv, "pair_sweep_forward": 3, "pair_sweep_backward": 3}),
    )
    res: dict = {"requests": {}, "indexed": {}, "against_indexed": {}, "checks": {}, "kernels_detail": {}}
    launches = dict(none)
    for label, p, c, batch, per_request in cases:
        calc = AIMNet2Calculator((p, c), device="cuda")
        res["requests"][label] = gas_request(label, calc, batch, False, per_request)
        for name, n in res["requests"][label]["launches"].items():
            launches[name] += n
        layout = calc._prep_cache["system"]
        if calc._prep_cache["kind"] != "packed" or layout.bins.nbins != (len(batch), 1, 1) \
                or layout.bins.capacity != 120:
            raise SystemExit(f"FAIL: {label} did not run on the molecule-bin layout of capacity 120")
        if label.startswith("packed-64"):
            _rows, res["kernels_detail"]["conv"] = phase_kernels(calc, layout, label)
        _rows, res["kernels_detail"][label] = phase_pair_kernels(calc, layout, label)

        # the same batch on the card's indexed layout (all-pairs lists)
        packed = calc.eval(batch, forces=True)
        calc_i = AIMNet2Calculator((p, c), device="cuda", binned_threshold=10**9)
        res["indexed"][label] = gas_request(f"{label} indexed", calc_i, batch, False, none)
        floor = F32_EPS * energy_terms_abs(p, c, layout)
        res["against_indexed"][label] = agree(f"{label} against the indexed layout", packed,
                                              calc_i.eval(batch, forces=True), floor)
        del calc_i

        # a 2 A move of every atom: the molecule-bin layout holds
        moved = moved_batch(batch, 2.0)
        got = calc.eval(moved, forces=True)
        if calc._prep_cache["system"] is not layout:
            raise SystemExit(f"FAIL: a 2 A move rebuilt the molecule-bin layout on {label}")
        fresh = AIMNet2Calculator((p, c), device="cuda").eval(moved, forces=True)
        for key in ("energy", "forces", "charges"):
            if not np.array_equal(got[key], fresh[key]):
                raise SystemExit(f"FAIL: after a 2 A move the kept layout gave another {key} than a fresh build "
                                 f"on {label}")
        log(f"[packed {label}] after a 2 A move of every atom the layout was kept; energy, forces and charges "
            f"equal a fresh build's bit for bit (largest |dE| against the unmoved batch "
            f"{np.abs(got['energy'] - packed['energy']).max():.3e} eV)")
        req, idx = res["requests"][label], res["indexed"][label]
        log(f"[packed {label}] request median reusing the layout {req['reused_median_s'] * 1e3:.2f} ms, building it "
            f"{req['built_median_s'] * 1e3:.2f} ms; the indexed layout on the same batch "
            f"{idx['reused_median_s'] * 1e3:.2f} / {idx['built_median_s'] * 1e3:.2f} ms; peak "
            f"{req['peak_bytes'] / 2**30:.3f} / {idx['peak_bytes'] / 2**30:.3f} GiB")
        del calc
        torch.cuda.empty_cache()
    res["launches"] = launches

    batch8 = [gas_cluster(n, seed=10 + k) for k, n in enumerate(GAS_BATCH)]
    for label, p, c in (("packed-8 flagship", params, cfg), ("packed-8 wb97m-d3", params_d3, cfg_d3)):
        layout = AIMNet2Calculator((p, c), device="cuda", binned_threshold=512).prepare_system(batch8)
        if layout.bins is None or not layout.bins.molecule_bins:
            raise SystemExit(f"FAIL: {label} is not on the molecule-bin layout")
        res["checks"][label] = gas_card_vs_cpu(label, p, c, batch8, False, binned_threshold=512)
    return res


MD_GAS = dict(dt_fs=0.5, temperature_K=300.0, thermostat="nve", skin=0.3, precision="exact")
MD_REPEAT_STEPS = 12  # steps of the md_gas bitwise repeat: a rebuild or two inside


def phase_md_gas(params, cfg, params_d3, cfg_d3) -> dict:
    """MD off the periodic binned path, at full width: md-mol-113 (the
    flagship on a 113-atom cluster, the indexed engine that a cell-less
    system takes by default; its 12.5 A diameter keeps every pair inside
    the 16 A LR list), md-periodic-500 (wb97m-d3 on the 500-atom box,
    ``engine="indexed"``) and md-cluster-10k-dsf (the flagship with DSF on
    the 10,000-atom cluster, ``engine="binned"`` on a gas-phase grid).  Each
    a fresh NVE driver from its Maxwell-Boltzmann start at 300 K (dt 0.5
    fs, skin 0.3 A, the exact tier), timed over its first 50 steps as
    ``md_window`` does (ms a step, idle share of a profiled chunk), gated on
    its launches (none on the indexed engine; A, B 3 and D, E 1 an
    evaluation on the grid), no overflow, fewer rebuilds than steps, the
    total energy within ``MD_NVE_DRIFT`` of itself, and two drivers of one
    seed equal bit for bit after a chunk; A, B, D and E held to their plain
    versions on md-cluster-10k-dsf's SR and LR grids; then ``MD_CHECK_STEPS``
    steps of md-mol-113 on the card against the CPU within ``CHECK_ABS``, with a
    ``fast`` control that must exceed it."""
    import torch

    from aimnetcentral_tpu_torch.calculators import AIMNet2Calculator
    from aimnetcentral_tpu_torch.dynamics import MDConfig, MDDriver

    md = MDConfig(**MD_GAS)
    mol = gas_cluster(113, seed=1)
    coord, numbers, cell = build_box(500, seed=2)
    none = {name: 0 for name in counters()}
    grid = {"conv_stencil_forward": 3, "conv_stencil_backward": 3, "pair_sweep_forward": 1,
            "pair_sweep_backward": 1}
    cases = (
        ("md-mol-113 flagship", params, cfg, mol, "auto", "indexed", none),
        ("md-periodic-500 wb97m-d3", params_d3, cfg_d3, {"coord": coord, "numbers": numbers, "cell": cell},
         "indexed", "indexed", none),
        ("md-cluster-10k-dsf flagship", params, dsf_config(cfg), gas_cluster(N_MAIN, seed=5), "binned", "binned",
         grid),
    )
    res: dict = {"windows": {}}
    for label, p, c, data, engine, want, per_eval in cases:
        system = md_system(data["coord"], data["numbers"], data.get("cell"), "cuda")
        t0 = time.perf_counter()
        drv = MDDriver(p, c, system, md, seed=0, engine=engine, device="cuda")
        drv.state  # the initial forces, outside the window
        torch.cuda.synchronize()
        setup = time.perf_counter() - t0
        if drv.engine != want:
            raise SystemExit(f"FAIL: {label} ran the {drv.engine} engine, not the {want}")
        st = drv.state.system
        shape = (f"SR grid {drv.grid.nbins} C={drv.grid.capacity}, LR grid {drv.lr_grid.nbins} "
                 f"C={drv.lr_grid.capacity}" if want == "binned" else
                 f"SR list {tuple(st.nbmat.shape)} (bins {drv.sr_spec.nbins}, capacity {drv.sr_spec.bin_capacity}), "
                 f"LR list {tuple(st.nbmat_lr.shape)} (bins {drv.lr_spec.nbins}, capacity "
                 f"{drv.lr_spec.bin_capacity})")
        log(f"[md_gas {label}] {drv.engine} engine, {shape}; driver and initial forces {setup:.2f} s")
        if want == "binned":
            # A, B, D and E at the shapes this driver gives them (its skin
            # makes other grids than a request's); the window below fails
            # on a regrow, so these shapes are the ones it runs
            check = AIMNet2Calculator((p, c), device="cuda")
            _rows, res["kernels_detail"] = phase_kernels(check, st, "md gas 10k")
            _rows, res["pair_kernels_detail"] = phase_pair_kernels(check, st, "md gas 10k")
            del check
        w = md_window(label, drv, per_eval, None, n_chunks=MD_WARM)
        if w["retried_chunks"] or w["rebins_per_100"] >= 100:
            raise SystemExit(f"FAIL: {label} overflowed or rebuilt every step")
        if w["etot_drift"] > MD_NVE_DRIFT:
            raise SystemExit(f"FAIL: NVE total energy moved by more than {MD_NVE_DRIFT} of itself on {label}")
        res["windows"][label] = {**w, "setup_s": setup}
        del drv
        snaps = []
        for _ in range(2):
            drv = MDDriver(p, c, system, md, seed=3, engine=engine, device="cuda")
            drv.run(MD_REPEAT_STEPS, chunk=MD_REPEAT_STEPS)
            snaps.append((drv.snapshot(), drv.rebins))
            del drv
        if not all(np.array_equal(snaps[0][0][k], snaps[1][0][k]) for k in ("coord", "veloc")):
            raise SystemExit(f"FAIL: two MD drivers of one seed gave other coordinates on {label}")
        log(f"[md_gas {label}] two drivers of one seed give the same coordinates and velocities bit for bit "
            f"after {MD_REPEAT_STEPS} steps ({snaps[0][1]} rebuilds)")
        torch.cuda.empty_cache()
    res["check"] = phase_md_card_vs_cpu("md-mol-113 flagship", params, cfg, mol)
    return res


ARTIFACT_SAE = {1: -13.6, 6: -1029.8, 7: -1485.3, 8: -2042.6}  # eV, H C N O
ARTIFACT_SPECIES = [1, 6, 7, 8]


def artifact_card_vs_cpu(label: str, path: str, data, stress: bool, binned_threshold: int = 1024) -> dict:
    """One request of the artifact at ``path`` on the card against the
    port's CPU run of the same file, within the absolute limits
    ``CHECK_ABS`` (energy per molecule, forces, stress)."""
    import torch

    from aimnetcentral_tpu_torch.calculators import AIMNet2Calculator

    runs = {}
    for dev in ("cuda", "cpu"):
        calc = AIMNet2Calculator(path, device=dev, binned_threshold=binned_threshold)
        t0 = time.perf_counter()
        runs[dev] = calc.eval(data, forces=True, stress=stress)
        if dev == "cuda":
            torch.cuda.synchronize()
            kind = calc._prep_cache["kind"]
        runs[dev + "_s"] = time.perf_counter() - t0
    diffs = {"energy": float(np.abs(runs["cuda"]["energy"] - runs["cpu"]["energy"]).max()),
             "forces": float(np.abs(runs["cuda"]["forces"] - runs["cpu"]["forces"]).max())}
    if stress:
        diffs["stress"] = float(np.abs(runs["cuda"]["stress"] - runs["cpu"]["stress"]).max())
    log(f"[artifact check {label}] {kind} layout, {len(runs['cuda']['forces'])} atoms: "
        + ", ".join(f"max |d{k}| {v:.3e} (limit {CHECK_ABS[k]:.1e})" for k, v in diffs.items())
        + f" (card {runs['cuda_s']:.2f} s, cpu {runs['cpu_s']:.2f} s)")
    if over_limits(diffs, CHECK_ABS):
        raise SystemExit(f"FAIL: the card and the CPU disagree on {label}: {over_limits(diffs, CHECK_ABS)}")
    return {**diffs, "layout": kind, "card_s": runs["cuda_s"], "cpu_s": runs["cpu_s"]}


def phase_artifact(params_d3, cfg_d3, coord, numbers, cell, out_dir: str) -> dict:
    """A released-style v2 artifact through the port's whole artifact path:
    ``train.export.export_model`` writes wb97m-d3's full-width random
    weights (seed 0) with an SAE for H, C, N and O and
    ``implemented_species`` [1, 6, 7, 8]; ``AIMNet2Calculator(path)`` loads
    it on the card with the artifact heads (SR Coulomb inside the model,
    external simple Coulomb without its SR part, external D3).  Then:
    artifact-10k (the 10,000-atom box: three counted requests, A, B 3 and
    D, E 4 a request, the SR Coulomb on the SR grid beside DSF, D3 CN and
    D3 energy on the LR grid; ten timed reusing the layout and ten building
    it, a bitwise repeat, a profiled request) against the in-memory source
    model (energy 1e-5 relative with the f32 floor, forces 1e-4 eV/A); D
    and E with each of the four pair terms against their plain versions on
    that layout and on packed-32x113's molecule bins; artifact-mol-113
    (indexed, no launches) and artifact-packed-32x113 (molecule bins, D and
    E 4 a request), each with times, a bitwise repeat and the host's spans
    (as ``gas_request``); the card against the CPU on the
    1,200-atom box and an 8-molecule packed batch within ``CHECK_ABS``; a
    request with an element outside ``implemented_species`` (Cl) raises
    ``ValueError`` and launches nothing."""
    import torch

    from aimnetcentral_tpu_torch.calculators import AIMNet2Calculator
    from aimnetcentral_tpu_torch.models.heads import DFTD3Head, LRCoulombHead, SRCoulombHead
    from aimnetcentral_tpu_torch.train.export import export_model

    path = os.path.join(out_dir, "artifact-wb97m-d3.pt")
    t0 = time.perf_counter()
    export_model(params_d3, cfg_d3, path, sae=ARTIFACT_SAE, implemented_species=ARTIFACT_SPECIES)
    t_export = time.perf_counter() - t0
    t0 = time.perf_counter()
    calc = AIMNet2Calculator(path, device="cuda")
    t_load = time.perf_counter() - t0
    heads = dict(calc.cfg.outputs)
    sr, coul, d3 = heads.get("srcoulomb"), heads.get("external_coulomb"), heads.get("external_dftd3")
    if not (isinstance(sr, SRCoulombHead) and isinstance(coul, LRCoulombHead) and coul.method == "simple"
            and not coul.subtract_sr and isinstance(d3, DFTD3Head)):
        raise SystemExit(f"FAIL: the artifact loaded with other heads: {list(heads)}")
    log(f"[artifact] exported in {t_export:.2f} s ({os.path.getsize(path) / 2**20:.1f} MiB), loaded onto the card "
        f"in {t_load:.2f} s; heads {list(heads)}; SR Coulomb rc {sr.rc} A ({sr.envelope}), external Coulomb "
        f"{coul.method} without its SR part, D3 s8 {d3.s8} a1 {d3.a1} a2 {d3.a2}")
    res: dict = {"export_s": t_export, "load_s": t_load}
    launches = {name: 0 for name in counters()}
    conv = {"conv_stencil_forward": 3, "conv_stencil_backward": 3}
    four = {**conv, "pair_sweep_forward": 4, "pair_sweep_backward": 4}

    res["main"] = phase_main_path("artifact-10k", calc, coord, numbers, cell, four)
    for name, n in res["main"]["launches"].items():
        launches[name] += n
    data = {"coord": coord, "numbers": numbers, "cell": cell}
    sysb = calc.prepare_system(data)
    if calc._prep_cache["kind"] != "binned":
        raise SystemExit("FAIL: artifact-10k did not run on the binned layout")
    # the in-memory source model, with the same SAE table
    table = np.zeros(64)
    for z, e in ARTIFACT_SAE.items():
        table[z] += e
    source = AIMNet2Calculator((params_d3, cfg_d3, {"sae": {"atomic_shift": table}}), device="cuda")
    got, ref = calc.eval(data, forces=True), source.eval(data, forces=True)
    floor = F32_EPS * energy_terms_abs(params_d3, cfg_d3, source.prepare_system(data))
    de = abs(float(got["energy"][0] - ref["energy"][0]))
    e_tol = max(REL_TOL * abs(float(ref["energy"][0])), floor)
    df = float(np.abs(got["forces"] - ref["forces"]).max())
    log(f"[artifact] artifact-10k against the in-memory source model: E {got['energy'][0]:.6f} against "
        f"{ref['energy'][0]:.6f} eV, |dE| {de:.3e} eV (limit {e_tol:.3e}: 1e-5 relative, floor {floor:.3e}); "
        f"max |dF| {df:.3e} eV/A (limit 1e-4)")
    if de > e_tol or df > 1e-4:
        raise SystemExit("FAIL: the loaded artifact and its source model disagree on artifact-10k")
    res["against_source"] = {"dE": de, "dE_limit": e_tol, "dF": df}
    del source
    torch.cuda.empty_cache()
    _rows, res["pair_kernels_detail"] = phase_pair_kernels(calc, sysb, "artifact 10k")

    mol = gas_cluster(113, seed=1)
    batch32 = [gas_cluster(113, seed=200 + k) for k in range(32)]
    none = {name: 0 for name in counters()}
    res["requests"] = {}
    for label, data_g, per_request in (("artifact-mol-113", mol, none), ("artifact-packed-32x113", batch32, four)):
        calc_g = AIMNet2Calculator(path, device="cuda")
        res["requests"][label] = gas_request(label, calc_g, data_g, False, per_request)
        for name, n in res["requests"][label]["launches"].items():
            launches[name] += n
        if label.startswith("artifact-packed"):
            layout = calc_g._prep_cache["system"]
            if calc_g._prep_cache["kind"] != "packed":
                raise SystemExit(f"FAIL: {label} did not run on the molecule-bin layout")
            _rows, res["packed_pair_kernels_detail"] = phase_pair_kernels(calc_g, layout, label)
        del calc_g
        torch.cuda.empty_cache()

    box_c, numbers_c, cell_c = build_box(CHECK_BOX, seed=1)
    batch8 = [gas_cluster(n, seed=10 + k) for k, n in enumerate(GAS_BATCH)]
    res["checks"] = {
        f"artifact-{CHECK_BOX}": artifact_card_vs_cpu(f"artifact-{CHECK_BOX}", path, {
            "coord": box_c, "numbers": numbers_c, "cell": cell_c}, True, binned_threshold=CHECK_THRESHOLD),
        "artifact-packed-8": artifact_card_vs_cpu("artifact-packed-8", path, batch8, False, binned_threshold=512),
    }
    if res["checks"]["artifact-packed-8"]["layout"] != "packed":
        raise SystemExit("FAIL: artifact-packed-8 did not run on the molecule-bin layout")

    # the species gate: an element outside implemented_species is refused
    # before any layout is built or kernel launched
    bad = {"coord": coord, "numbers": numbers.copy(), "cell": cell}
    bad["numbers"][0] = 17
    wrappers = counters()
    for fn in wrappers.values():
        fn.launches = 0
    try:
        calc.eval(bad, forces=True)
    except ValueError as e:
        refused = str(e)
    else:
        raise SystemExit("FAIL: a request with Cl passed the species gate")
    gate = {name: fn.launches for name, fn in wrappers.items()}
    if any(gate.values()):
        raise SystemExit(f"FAIL: the refused request launched kernels: {gate}")
    log(f"[artifact] a request with Cl is refused without a launch: {refused[:90]}")
    res["launches"] = launches
    return res


SO_V_SEEDS = (31, 32, 33)  # the seeded v of the HVP checks
SO_LANCZOS_K = 6  # Lanczos steps of the card-against-CPU lambda_min check
SO_NEB_IMAGES, SO_NEB_STEPS, SO_TS_STEPS = 7, 5, 3
# limits of the second-order checks, each relative to the largest magnitude,
# from the noise measured on the card at the exact tier (PERF.md, section 6): H's
# asymmetry and translation sums 5.1e-7 at most (limit 20x), H v 3.5e-6 card
# against CPU (3x; the fast-tier control came out at 1.4e-4 and above), the
# K3 route against the all-plain route 1.6e-6 (6x; control 1.1e-3 and
# above), the first Lanczos eigenvalue 7.7e-7 (13x)
SO_SYM_REL = 1e-5  # max |H - H^T| and the translation sums, over max |H|
SO_HVP_REL = 1e-5  # H v: the dense product, the card's HVP and the CPU's, over max |H v|
SO_K3_REL = 1e-5  # the K3 route against the all-plain route on the card, over max |H v|
SO_LAM_REL = 1e-5  # the first Lanczos eigenvalue, card against CPU, over |lambda|


@contextlib.contextmanager
def plain_route():
    """The binned engine's kernel wrappers swapped for their plain versions,
    for the K3 check's all-plain route on the card (the port never takes a
    plain version for a CUDA tensor).  Nothing launches inside."""
    from aimnetcentral_tpu_torch.kernels import conv_pass as cp
    from aimnetcentral_tpu_torch.kernels import conv_stencil as cs
    from aimnetcentral_tpu_torch.kernels import pair_sweep as ps

    saved = (cp.conv_stencil_forward, cp.conv_stencil_backward, ps.pair_sweep_forward, ps.pair_sweep_backward)
    cp.conv_stencil_forward = cs.conv_forward_plain
    cp.conv_stencil_backward = (
        lambda st, a, c, mask, shift, nbr, _mnbr, shifts_g, scal, gbar:
        cs.conv_backward_plain(st, a, c, mask, shift, nbr, shifts_g, scal, gbar)
    )
    ps.pair_sweep_forward, ps.pair_sweep_backward = ps.pair_forward_plain, ps.pair_backward_plain
    try:
        yield
    finally:
        cp.conv_stencil_forward, cp.conv_stencil_backward, ps.pair_sweep_forward, ps.pair_sweep_backward = saved


def reset_counts() -> dict:
    """Every kernel's launch count set to 0; returns the wrappers."""
    wrappers = counters()
    for fn in wrappers.values():
        fn.launches = 0
    return wrappers


def read_counts(wrappers: dict) -> dict:
    return {name: fn.launches for name, fn in wrappers.items()}


def hessian_request(label: str, calc, mol: dict) -> dict:
    """Two ``calc.eval(mol, hessian=True)`` requests at the calculator's
    tier: wall time of each (the second reuses the layout), peak device
    memory, launches (none: the indexed layout); the Hessian finite, its
    largest asymmetry and translation sum (each row summed over the atoms)
    against its largest entry, and the two bit for bit equal.  A fresh
    process's first Hessian is held to its repeats by ``fresh_hessian``."""
    import torch

    wrappers = reset_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    times, outs = [], []
    for _ in range(2):
        t0 = time.perf_counter()
        outs.append(calc.eval(mol, hessian=True))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated() - held
    launches = read_counts(wrappers)
    if calc._prep_cache["kind"] != "indexed" or any(launches.values()):
        raise SystemExit(f"FAIL: the Hessian of {label} ran on the {calc._prep_cache['kind']} layout ({launches})")
    h = outs[0]["hessian"]
    n = len(mol["numbers"])
    if h.shape != (n, 3, n, 3) or not np.isfinite(h).all():
        raise SystemExit(f"FAIL: the Hessian of {label} has shape {h.shape} or is not finite")
    if not np.array_equal(h, outs[1]["hessian"]):
        raise SystemExit(f"FAIL: two Hessians of {label} differ")
    flat = h.reshape(3 * n, 3 * n).astype(np.float64)
    scale = float(np.abs(flat).max())
    asym = float(np.abs(flat - flat.T).max()) / scale
    trans = float(np.abs(h.astype(np.float64).sum(axis=2)).max()) / scale
    log(f"[second_order {label}] dense Hessian ({n} atoms, {3 * n} rows): {times[0]:.3f} s, repeated "
        f"{times[1]:.3f} s (layout reused), peak {peak / 2**30:.3f} GiB above the {held / 2**30:.3f} held, "
        f"launches {launches}; max |H| {scale:.4e} eV/A^2, max |H - H^T| {asym:.3e} and max |sum_j H[i,:,j,:]| "
        f"{trans:.3e} of it; a repeat equal bit for bit")
    if asym > SO_SYM_REL or trans > SO_SYM_REL:
        raise SystemExit(f"FAIL: the Hessian of {label} is not symmetric or not translation invariant "
                         f"(limit {SO_SYM_REL:.0e} of max |H|)")
    return {"s": times[0], "repeat_s": times[1], "peak_bytes": peak, "launches": launches, "max_abs": scale,
            "asym_rel": asym, "trans_rel": trans, "hessian": h}


FRESH_HESSIAN = """
import json, sys
sys.path.insert(0, {root!r})
import numpy as np
import torch
import chip_smoke as smoke
from aimnetcentral_tpu_torch.calculators import AIMNet2Calculator, derivatives
from aimnetcentral_tpu_torch.models import aimnet2_init
chunks = []
chunk_of = derivatives.hessian_chunk
def logged(system, rows, graph_bytes):
    chunks.append((rows, graph_bytes, chunk_of(system, rows, graph_bytes)))
    return chunks[-1][2]
derivatives.hessian_chunk = logged
cfg = smoke.flagship_config()
calc = AIMNet2Calculator((aimnet2_init(cfg, seed=0, device="cuda"), cfg), device="cuda")
mol = smoke.gas_cluster(113, seed=1)
h, held = [], []
for _ in range(3):
    held.append(torch.cuda.memory_allocated())
    h.append(calc.eval(mol, hessian=True)["hessian"])
held.append(torch.cuda.memory_allocated())
print(json.dumps({{"equal": [bool(np.array_equal(h[0], x)) for x in h[1:]],
                  "differing": [int((h[0] != x).sum()) for x in h[1:]],
                  "max_abs_diff": [float(np.abs(h[0].astype(np.float64) - x).max()) for x in h[1:]],
                  "max_abs": float(np.abs(h[0]).max()), "chunks": chunks,
                  "held_growth": [b - a for a, b in zip(held, held[1:])]}}))
"""


def fresh_hessian() -> dict:
    """The first dense Hessian of a fresh process (mol-113 flagship at
    ``exact``, nothing differentiated before it) against its two repeats, in
    a subprocess started for it alone."""
    out = subprocess.run([sys.executable, "-c", FRESH_HESSIAN.format(root=ROOT)], capture_output=True, text=True,
                         timeout=600)
    if out.returncode != 0:
        raise SystemExit(f"FAIL: the fresh-process Hessian did not run:\n{out.stderr[-3000:]}")
    res = json.loads(out.stdout.strip().splitlines()[-1])
    log(f"[second_order fresh] mol-113 flagship, the first dense Hessian of a fresh process against its two "
        f"repeats: equal bit for bit {res['equal']}, entries differing {res['differing']}, largest |dH| "
        f"{res['max_abs_diff']} of max |H| {res['max_abs']:.4e}; (rows, graph bytes, chunk) of each "
        f"{res['chunks']}; memory the process keeps after each request {res['held_growth']} B (a first "
        f"request's one-time allocations, cuBLAS's workspace among them)")
    if not all(res["equal"]):
        raise SystemExit("FAIL: the first dense Hessian of a fresh process differs from its repeats")
    return res


def hvp_checks(label: str, params, cfg, mol: dict, h: np.ndarray) -> dict:
    """H v for the seeded v: the dense Hessian's product against
    ``hessian_vector_product`` on the card and against the port's CPU HVP,
    within ``SO_HVP_REL`` of max |H v|; the card's ``fast`` tier (TF32) is
    the control that must exceed it."""
    import torch

    from aimnetcentral_tpu_torch.calculators import AIMNet2Calculator
    from aimnetcentral_tpu_torch.models.bridge import params_to

    n = len(mol["numbers"])
    card = AIMNet2Calculator((params, cfg), device="cuda")
    fast = AIMNet2Calculator((params, cfg), device="cuda", precision="fast")
    cpu = AIMNet2Calculator((params_to(params, torch.device("cpu")), cfg), device="cpu")
    res = {"dense": 0.0, "cpu": 0.0, "fast": float("inf"), "card_ms": [], "cpu_s": []}
    for seed in SO_V_SEEDS:
        v = np.random.default_rng(seed).normal(size=(n, 3)).astype(np.float32)
        t0 = time.perf_counter()
        hv = card.hessian_vector_product(mol, v)
        torch.cuda.synchronize()
        res["card_ms"].append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        hv_cpu = cpu.hessian_vector_product(mol, v)
        res["cpu_s"].append(time.perf_counter() - t0)
        hv_fast = fast.hessian_vector_product(mol, v)
        dense = (h.reshape(3 * n, 3 * n).astype(np.float64) @ v.reshape(-1)).reshape(n, 3)
        scale = float(np.abs(hv_cpu).max())
        res["dense"] = max(res["dense"], float(np.abs(dense - hv).max()) / scale)
        res["cpu"] = max(res["cpu"], float(np.abs(hv - hv_cpu).max()) / scale)
        res["fast"] = min(res["fast"], float(np.abs(hv_fast - hv_cpu).max()) / scale)
    log(f"[second_order {label}] H v for {len(SO_V_SEEDS)} seeded v, largest differences over max |H v|: the dense "
        f"Hessian's product against hessian_vector_product {res['dense']:.3e}, the card against the CPU "
        f"{res['cpu']:.3e} (limit {SO_HVP_REL:.0e}); control: the fast tier against the CPU at least "
        f"{res['fast']:.3e}; HVP on the card {np.median(res['card_ms']):.2f} ms (median), on the CPU "
        f"{np.median(res['cpu_s']):.2f} s")
    if max(res["dense"], res["cpu"]) > SO_HVP_REL:
        raise SystemExit(f"FAIL: H v disagrees on {label}")
    if res["fast"] <= SO_HVP_REL:
        raise SystemExit(f"FAIL: the fast-tier control passed the HVP limit on {label}: it cannot see TF32")
    return res


def k3_route(label: str, calc, data, per_request: dict) -> dict:
    """``make_hvp_fn`` on a binned or packed layout, the K3 route: kernels
    A, B, D and E as the primals (their launches read around one HVP) and
    the second-order tangents on the plain versions, against the all-plain
    route on the card within ``SO_K3_REL`` of max |H v|, which the kernel
    route at the ``fast`` tier must exceed; the time of each route."""
    import torch

    from aimnetcentral_tpu_torch.calculators.calculator import ambient_matmul_context
    from aimnetcentral_tpu_torch.calculators.derivatives import make_hvp_fn

    system = calc.prepare_system(data)
    if system.bins is None:
        raise SystemExit(f"FAIL: {label} is not on a binned layout")
    hvp = make_hvp_fn(calc._effective_cfg(system.cell is not None))
    real = (system.numbers > 0)[:, None]
    gen = torch.Generator(device="cuda").manual_seed(41)
    v = torch.where(real, torch.randn(system.coord.shape, generator=gen, device="cuda"), 0.0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with ambient_matmul_context("highest"):
        hvp(calc.params, system, v)  # warm-up
        wrappers = reset_counts()
        t0 = time.perf_counter()
        hv = hvp(calc.params, system, v)
        torch.cuda.synchronize()
        t_kernel = time.perf_counter() - t0
        launches = read_counts(wrappers)
        with plain_route():
            t0 = time.perf_counter()
            plain = hvp(calc.params, system, v)
            torch.cuda.synchronize()
            t_plain = time.perf_counter() - t0
        if read_counts(wrappers) != launches:
            raise SystemExit(f"FAIL: the plain route of {label} launched a kernel")
    with ambient_matmul_context("default"):
        fast = hvp(calc.params, system, v)
    peak = torch.cuda.max_memory_allocated()
    scale = float(plain.abs().max())
    d = float((hv - plain).abs().max()) / scale
    d_fast = float((fast - plain).abs().max()) / scale
    grid = system.bins
    log(f"[second_order K3 {label}] {int(real.sum())} atoms, grid {grid.nbins} C={grid.capacity}: HVP on the "
        f"kernel route {t_kernel * 1e3:.1f} ms (launches {launches}), on the all-plain route {t_plain * 1e3:.1f} "
        f"ms; max |dHv| {d:.3e} of max |H v| {scale:.4e} (limit {SO_K3_REL:.0e}); control: the fast tier "
        f"{d_fast:.3e}; peak {peak / 2**30:.3f} GiB")
    if not torch.isfinite(hv).all() or d > SO_K3_REL:
        raise SystemExit(f"FAIL: the K3 route and the all-plain route disagree on {label}")
    if d_fast <= SO_K3_REL:
        raise SystemExit(f"FAIL: the fast-tier control passed the K3 limit on {label}")
    for name, n in launches.items():
        if n != per_request[name]:
            raise SystemExit(f"FAIL: {name} launched {n} times in one HVP on {label}, expected {per_request[name]}")
    return {"kernel_ms": t_kernel * 1e3, "plain_ms": t_plain * 1e3, "rel": d, "fast_rel": d_fast,
            "launches": launches, "peak_bytes": peak}


def phase_second_order(params, cfg, params_d3, cfg_d3) -> dict:
    """Second derivatives at full width (``phase_second_order``): the dense
    Hessian of mol-113 (flagship and wb97m-d3) through
    ``AIMNet2Calculator.eval(hessian=True)`` at ``exact`` (the indexed
    layout: no launch), H v checks; vibrations of mol-113 flagship
    (frequencies, IR intensities of every mode but the six projected null
    ones in one 666-molecule request on molecule bins: A 3 and D 1, RRHO),
    8 displaced molecules card against CPU; ``ts_search`` (3 steps) and
    ``neb`` (7 images, 5 iterations), the first Lanczos eigenvalue from one
    start and the first band's energies and forces card against CPU; and
    the K3 route (``make_hvp_fn`` on the 1,200-atom flagship box, binned
    with DSF, and on packed-8's molecule bins) against the all-plain route
    on the card."""
    import torch

    from aimnetcentral_tpu_torch.builders import system_from_molecules
    from aimnetcentral_tpu_torch.calculators import AIMNet2Calculator
    from aimnetcentral_tpu_torch.calculators.derivatives import make_hvp_fn
    from aimnetcentral_tpu_torch.dynamics import frequencies_from_calculator, linear_band, neb, ts_search
    from aimnetcentral_tpu_torch.dynamics.neb import band_energy_forces
    from aimnetcentral_tpu_torch.dynamics.saddle import lanczos_min_mode
    from aimnetcentral_tpu_torch.dynamics.vibrations import ir_intensities, rrho_thermochemistry
    from aimnetcentral_tpu_torch.models.bridge import params_to

    t_phase = time.perf_counter()
    cpu_dev = torch.device("cpu")
    mol = gas_cluster(113, seed=1)
    res: dict = {"hessian": {}, "hvp": {}, "fresh": fresh_hessian()}
    launches = {name: 0 for name in counters()}
    for label, p, c in (("mol-113 flagship", params, cfg), ("mol-113 wb97m-d3", params_d3, cfg_d3)):
        calc = AIMNet2Calculator((p, c), device="cuda")
        req = hessian_request(label, calc, mol)
        res["hvp"][label] = hvp_checks(label, p, c, mol, req.pop("hessian"))
        res["hessian"][label] = req
        del calc
        torch.cuda.empty_cache()

    # vibrations of mol-113 flagship
    calc = AIMNet2Calculator((params, cfg), device="cuda")
    t0 = time.perf_counter()
    freqs, modes = frequencies_from_calculator(calc, mol, project_rotations=True)
    t_freq = time.perf_counter() - t0
    keep = np.sort(np.argsort(np.abs(freqs), kind="stable")[6:])  # all but the six projected null modes
    wrappers = reset_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    intens = ir_intensities(calc, mol, modes[keep])
    torch.cuda.synchronize()
    t_ir = time.perf_counter() - t0
    ir_launches = read_counts(wrappers)
    ir_peak = torch.cuda.max_memory_allocated()
    layout = calc._prep_cache["system"]
    n_disp = 2 * len(keep)
    want = {"conv_stencil_forward": 3, "conv_stencil_backward": 0, "pair_sweep_forward": 1, "pair_sweep_backward": 0}
    if calc._prep_cache["kind"] != "packed" or layout.bins.nbins[0] != n_disp or ir_launches != want:
        raise SystemExit(f"FAIL: the IR request did not run once on {n_disp} molecule bins ({ir_launches})")
    if intens.shape != (len(keep),) or not np.isfinite(intens).all() or (intens < 0).any():
        raise SystemExit("FAIL: IR intensities wrong in shape, not finite or negative")
    for name, n in ir_launches.items():
        launches[name] += n
    thermo = rrho_thermochemistry(freqs, mol["numbers"], mol["coord"])
    if not all(np.isfinite(v) for v in thermo.values()):
        raise SystemExit("FAIL: RRHO thermochemistry not finite")
    log(f"[second_order vibrations] mol-113 flagship: frequencies (rotations projected) {t_freq:.3f} s, "
        f"{int((freqs < -10).sum())} imaginary below -10 cm^-1 and {int((freqs > 10).sum())} real above 10 "
        f"(random weights); IR intensities of {len(keep)} modes: one request of {n_disp} molecules, "
        f"{n_disp * len(mol['numbers'])} atoms on molecule bins (capacity {layout.bins.capacity}), "
        f"{t_ir * 1e3:.1f} ms, peak {ir_peak / 2**30:.3f} GiB, launches {ir_launches}; largest intensity "
        f"{intens.max():.4e} km/mol; RRHO at 298.15 K: ZPE {thermo['zpe']:.6f} eV, G {thermo['g']:.6f} eV, "
        f"{thermo['n_skipped_modes']} modes skipped")
    res["vibrations"] = {"freq_s": t_freq, "ir_s": t_ir, "ir_peak_bytes": ir_peak, "ir_launches": ir_launches,
                         "ir_molecules": n_disp, "n_imaginary": int((freqs < -10).sum()),
                         "zpe": thermo["zpe"], "g": thermo["g"]}
    # 8 of the displaced molecules (4 modes, both signs) on molecule bins, card against CPU
    eight = [{**mol, "coord": (mol["coord"] + s * 0.01 * modes[keep[k]]).astype(np.float32)}
             for s in (1.0, -1.0) for k in range(4)]
    res["vibrations"]["check"] = gas_card_vs_cpu("ir-8 displaced flagship", params, cfg, eight, False,
                                                 binned_threshold=512)

    # ts_search and neb on mol-113 flagship
    system = system_from_molecules([mol], torch.device("cuda"), build_nbmat=True)
    t0 = time.perf_counter()
    _moved, ts_info = ts_search(params, cfg, system, fmax=1e-9, max_steps=SO_TS_STEPS)
    torch.cuda.synchronize()
    t_ts = time.perf_counter() - t0
    if ts_info["steps"] != SO_TS_STEPS or not np.isfinite(ts_info["fmax"]) or not np.isfinite(ts_info["lambda_min"]):
        raise SystemExit(f"FAIL: ts_search on mol-113: {ts_info}")
    # the first Lanczos eigenvalue from one numpy-seeded start, card against CPU
    lams = {}
    p_cpu = params_to(params, cpu_dev)
    for dev, p in ((torch.device("cuda"), params), (cpu_dev, p_cpu)):
        sysd = system_from_molecules([mol], dev, build_nbmat=True)
        real = (sysd.numbers > 0)[:, None]
        v0 = np.random.default_rng(51).normal(size=tuple(sysd.coord.shape)).astype(np.float32)
        hvp = make_hvp_fn(cfg)
        lam, _v = lanczos_min_mode(lambda x, v, p=p, s=sysd: hvp(p, s.replace(coord=x), v), sysd.coord,
                                   torch.as_tensor(v0, device=dev), real, k=SO_LANCZOS_K)
        lams[dev.type] = float(lam)
    d_lam = abs(lams["cuda"] - lams["cpu"])
    log(f"[second_order ts_search] mol-113 flagship, {SO_TS_STEPS} steps (15 Lanczos HVPs a step, then the "
        f"closing force and Lanczos): {t_ts:.3f} s, {t_ts / (SO_TS_STEPS + 1) * 1e3:.1f} ms a step (wall over "
        f"{SO_TS_STEPS + 1}); fmax {ts_info['fmax']:.4e}, lambda_min {ts_info['lambda_min']:.6e}; "
        f"{SO_LANCZOS_K}-step Lanczos from one start: card {lams['cuda']:.6e}, CPU {lams['cpu']:.6e}, "
        f"|d| {d_lam:.3e} (limit {SO_LAM_REL:.0e} of |lambda|)")
    if d_lam > SO_LAM_REL * abs(lams["cpu"]):
        raise SystemExit("FAIL: the card and the CPU disagree on lambda_min")
    res["ts"] = {"s": t_ts, "ms_per_step": t_ts / (SO_TS_STEPS + 1) * 1e3, "lambda_card": lams["cuda"],
                 "lambda_cpu": lams["cpu"]}

    step = np.random.default_rng(61).normal(size=mol["coord"].shape)
    step *= 0.2 / np.linalg.norm(step, axis=1, keepdims=True)
    prod = {**mol, "coord": (mol["coord"] + step).astype(np.float32)}
    t0 = time.perf_counter()
    band, energies, neb_info = neb(params, cfg, mol, prod, n_images=SO_NEB_IMAGES, max_steps=SO_NEB_STEPS,
                                   fmax=1e-9, device="cuda")
    torch.cuda.synchronize()
    t_neb = time.perf_counter() - t0
    if neb_info["steps"] != SO_NEB_STEPS or not torch.isfinite(band).all() or not torch.isfinite(energies).all():
        raise SystemExit(f"FAIL: neb on mol-113: {neb_info}")
    firsts = {}
    for dev, p in ((torch.device("cuda"), params), (cpu_dev, p_cpu)):
        band0 = linear_band(torch.as_tensor(mol["coord"], device=dev), torch.as_tensor(prod["coord"], device=dev),
                            SO_NEB_IMAGES)
        e0, f0 = band_energy_forces(p, cfg, mol, SO_NEB_IMAGES, dev)(band0)
        firsts[dev.type] = (e0.cpu().numpy().astype(np.float64), f0.cpu().numpy())
    de = float(np.abs(firsts["cuda"][0] - firsts["cpu"][0]).max())
    df = float(np.abs(firsts["cuda"][1] - firsts["cpu"][1]).max())
    e_tol = max(REL_TOL * float(np.abs(firsts["cpu"][0]).max()), CHECK_ABS["energy"])
    log(f"[second_order neb] mol-113 flagship, {SO_NEB_IMAGES} images ({SO_NEB_IMAGES * 113} atoms a band), "
        f"{SO_NEB_STEPS} iterations: {t_neb:.3f} s, {t_neb / (SO_NEB_STEPS + 1) * 1e3:.1f} ms an iteration (wall "
        f"over {SO_NEB_STEPS + 1} band evaluations); fmax {neb_info['fmax']:.4e}; first band card against CPU: "
        f"|dE| {de:.3e} eV (limit {e_tol:.3e}), max |dF| {df:.3e} eV/A (limit 1e-4)")
    if de > e_tol or df > 1e-4:
        raise SystemExit("FAIL: the card and the CPU disagree on the first NEB band")
    res["neb"] = {"s": t_neb, "ms_per_iter": t_neb / (SO_NEB_STEPS + 1) * 1e3, "dE": de, "dF": df}
    del calc
    torch.cuda.empty_cache()

    # the K3 route: binned box (DSF) and packed-8 (simple Coulomb)
    coord, numbers, cell = build_box(N_CHECK, seed=1)
    # reverse-over-reverse: B runs in both backward passes (the first
    # adjoint's cotangents depend on every conv pass's output), E in the
    # first only (Coulomb's cotangent does not depend on its sweep's output)
    per = {"conv_stencil_forward": 3, "conv_stencil_backward": 6, "pair_sweep_forward": 1, "pair_sweep_backward": 1}
    batch8 = [gas_cluster(n, seed=10 + k) for k, n in enumerate(GAS_BATCH)]
    res["k3"] = {
        "box-1200 flagship": k3_route("box-1200 flagship", AIMNet2Calculator((params, cfg), device="cuda"),
                                      {"coord": coord, "numbers": numbers, "cell": cell}, per),
        "packed-8 flagship": k3_route("packed-8 flagship",
                                      AIMNet2Calculator((params, cfg), device="cuda", binned_threshold=512),
                                      batch8, per),
    }
    for run in res["k3"].values():
        for name, n in run["launches"].items():
            launches[name] += n
    res["launches"] = launches
    res["seconds"] = time.perf_counter() - t_phase
    log(f"[second_order] phase {res['seconds']:.1f} s")
    return res


LR_PME_REL = 2e-3  # PME against Ewald, of max(1, |E|) (the JAX package's tests/test_pme.py:71)
LR_HVP_BOX = 64  # atoms of the second-order check's periodic box
LR_DISP_SEED = 0  # the positive per-element C6 and alpha of lr-heads' disp_param0


def ewald_config(cfg, method: str = "ewald"):
    """``cfg`` with its Coulomb head's method set to Ewald or PME (what
    ``AIMNet2Calculator.set_lrcoulomb_method`` does)."""
    from aimnetcentral_tpu_torch.models.heads import LRCoulombHead

    return dataclasses.replace(cfg, outputs=tuple(
        (n, dataclasses.replace(h, method=method) if isinstance(h, LRCoulombHead) else h) for n, h in cfg.outputs
    ))


def lr_heads_model(cfg, seed: int = 0):
    """The flagship width with the head set of the JAX package's
    tests/test_ensemble_fused.py:299-306 on top of the flagship's heads:
    SRRep (cosine cutoff at 4 A, into the energy), an OutputHead giving
    ``disp_param``, DispParam and D3TS(a1=0.49, a2=3.5, s8=0.78); random
    weights (``seed``) and ``disp_param0`` filled with positive C6 and
    alpha per element (its zero init makes D3TS exactly zero)."""
    import torch

    from aimnetcentral_tpu_torch.models import aimnet2_init
    from aimnetcentral_tpu_torch.models.heads import D3TSHead, DispParamHead, OutputHead, SRRepHead
    from aimnetcentral_tpu_torch.models.modules import MLPSpec

    cfg = dataclasses.replace(cfg, outputs=cfg.outputs + (
        ("srrep", SRRepHead(key_out="energy", rc=4.0, cutoff_fn="cosine_cutoff")),
        ("disp_raw", OutputHead(n_in=256, n_out=2, key_in="aim", key_out="disp_param",
                                mlp=MLPSpec(hidden=(128,), last_linear=True))),
        ("disp_param", DispParamHead()),
        ("d3ts", D3TSHead(a1=0.49, a2=3.5, s8=0.78)),
    ))
    params = aimnet2_init(cfg, seed=seed, device="cuda")
    rng = np.random.default_rng(LR_DISP_SEED)
    tab = np.zeros((87, 2), np.float32)
    tab[1:, 0] = rng.uniform(2.0, 40.0, size=86)
    tab[1:, 1] = rng.uniform(3.0, 15.0, size=86)
    tab[0, 1] = 1.0
    params["outputs"]["disp_param"]["disp_param0"] = torch.as_tensor(tab, device="cuda")
    return params, cfg


def lr_hvp_check(params, cfg) -> dict:
    """One HVP with Ewald on a small periodic box (indexed layout: plain
    torch twice differentiated), the card against the CPU within
    ``SO_HVP_REL`` of the largest |H v|, with the ``fast`` tier as the
    control that must exceed it."""
    import torch

    from aimnetcentral_tpu_torch.calculators import AIMNet2Calculator
    from aimnetcentral_tpu_torch.models.bridge import params_to

    coord, numbers, cell = build_box(LR_HVP_BOX, seed=3)
    data = {"coord": coord, "numbers": numbers, "cell": cell}
    v = np.random.default_rng(SO_V_SEEDS[0]).normal(size=(LR_HVP_BOX, 3)).astype(np.float32)
    t0 = time.perf_counter()
    cpu = AIMNet2Calculator((params_to(params, torch.device("cpu")), cfg), device="cpu").hessian_vector_product(
        data, v)
    t_cpu = time.perf_counter() - t0
    res = {"cpu_s": t_cpu}
    for tier in ("exact", "fast"):
        calc = AIMNet2Calculator((params, cfg), device="cuda", precision=tier)
        t0 = time.perf_counter()
        hv = calc.hessian_vector_product(data, v)
        torch.cuda.synchronize()
        res[tier] = {"rel": float(np.abs(hv - cpu).max() / np.abs(cpu).max()), "card_s": time.perf_counter() - t0}
        if calc._prep_cache["kind"] != "indexed" or calc._prep_cache["system"].ewald_kpts is None:
            raise SystemExit("FAIL: the Ewald HVP did not run on the indexed layout with its discretisation")
    log(f"[long_range hvp] {LR_HVP_BOX}-atom box, Ewald: H v card against CPU {res['exact']['rel']:.2e} of "
        f"max |H v| (limit {SO_HVP_REL:.0e}); fast-tier control {res['fast']['rel']:.2e}; card "
        f"{res['exact']['card_s']:.2f} s, cpu {t_cpu:.2f} s")
    if res["exact"]["rel"] > SO_HVP_REL:
        raise SystemExit("FAIL: the Ewald HVP disagrees between the card and the CPU")
    if res["fast"]["rel"] <= SO_HVP_REL:
        raise SystemExit("FAIL: the fast-tier control passed the Ewald HVP limit: it cannot see TF32")
    return res


def lr_exact_products(sysb) -> dict:
    """Ewald's reciprocal, self and background energy on ewald-10k's layout
    (seeded neutral charges) at the ``fast`` tier (TF32 matmuls on) against
    an f64 run: within 1e-5 relative, since the phase ``k . r`` and the
    structure factors are exact f32 products at every tier.  The control
    rounds the phase's operands to TF32's 10-bit mantissa, as a TF32 matmul
    would (whatever kernel cuBLAS picks for an inner dimension of 3); it
    must exceed the limit, or the gate could not see TF32."""
    import torch

    from aimnetcentral_tpu_torch.calculators.calculator import ambient_matmul_context
    from aimnetcentral_tpu_torch.models import ewald

    gen = torch.Generator(device="cuda").manual_seed(5)
    q = torch.randn(sysb.natoms, generator=gen, device="cuda") * 0.3 * (sysb.numbers > 0)
    q = torch.where(sysb.numbers > 0, q - q.sum() / (sysb.numbers > 0).sum(), 0.0)

    def energy(system, qq, phase=None):
        args = (system.coord, qq[:, None], system.cell, system.mol_idx, 1, system.ewald_eta, system.ewald_k_cutoff,
                system.ewald_kpts)
        saved = ewald._phase
        if phase is not None:
            ewald._phase = phase
        try:
            with ambient_matmul_context("default"), torch.no_grad():
                return float(ewald.ewald_nonreal_multi(*args).double().sum())
        finally:
            ewald._phase = saved

    e64 = energy(sysb.replace(coord=sysb.coord.double(), cell=sysb.cell.double(),
                              ewald_eta=sysb.ewald_eta.double(), ewald_k_cutoff=sysb.ewald_k_cutoff.double()),
                 q.double())
    e_fast = energy(sysb, q)
    def tf32(x):  # drop the 13 low mantissa bits
        return (x.view(torch.int32) & -8192).view(torch.float32)

    exact_phase = ewald._phase
    e_tf32 = energy(sysb, q, phase=lambda c, kvec, m, n: exact_phase(tf32(c), tf32(kvec), m, n))
    res = {"f64": e64, "fast": e_fast, "tf32_phase": e_tf32, "fast_rel": abs(e_fast - e64) / abs(e64),
           "tf32_rel": abs(e_tf32 - e64) / abs(e64)}
    log(f"[long_range exact] Ewald reciprocal + self + background on ewald-10k at the fast tier: "
        f"{res['fast_rel']:.2e} relative to f64 (limit {REL_TOL:.0e}); the control with TF32-rounded phase "
        f"operands {res['tf32_rel']:.2e}")
    if res["fast_rel"] > REL_TOL:
        raise SystemExit("FAIL: Ewald's reciprocal energy at the fast tier is farther than 1e-5 from f64")
    if res["tf32_rel"] <= REL_TOL:
        raise SystemExit("FAIL: the TF32-phase control passed the Ewald limit: it cannot see TF32")
    return res


def phase_long_range(params, cfg, params_d3, cfg_d3, coord, numbers, cell) -> dict:
    """Ewald, PME, SRRep, DispParam, D3TS and a model without d2features at
    full width (``phase_long_range``): D and E with each new term against
    their plain versions (the real-space Ewald sum on ewald-10k's LR grid
    and on the 1,200-atom box's, where one atom meets several images of a
    neighbour; SRRep on lr-heads-10k's SR grid; D3TS, and DSF again, on its
    LR grid); Ewald's reciprocal energy at the ``fast`` tier against f64,
    with a TF32-phase control (``lr_exact_products``); the
    requests ewald-10k and pme-10k (flagship, A, B 3 and D, E 1: the
    real-space sum with the SR part inside), lr-heads-10k (D, E 3: SRRep,
    DSF, D3TS), nod2-10k (A, B 3 and D, E 1), each with launches, times,
    peak, a profiled request and a bitwise repeat, and PME against Ewald;
    ewald-periodic-500 (wb97m-d3 with Ewald, indexed, stress); the card
    against the CPU on the 1,200-atom box for Ewald (a charged cell), PME
    and lr-heads and on ewald-periodic-500; md-ewald-10k, the first 50 NVE
    steps at exact (launches a step, step time) and the same 25 fs at half
    the time step (NVE energy), and two drivers of one seed bit for bit;
    and one Ewald HVP, card against CPU with a ``fast`` control."""
    import torch

    from aimnetcentral_tpu_torch.calculators import AIMNet2Calculator
    from aimnetcentral_tpu_torch.dynamics import MDConfig, MDDriver
    from aimnetcentral_tpu_torch.models import aimnet2_init

    t_phase = time.perf_counter()
    cfg_ew, cfg_pme = ewald_config(cfg), ewald_config(cfg, "pme")
    params_lr, cfg_lr = lr_heads_model(cfg)
    cfg_nod2 = dataclasses.replace(cfg, d2features=False)
    params_nod2 = aimnet2_init(cfg_nod2, seed=0, device="cuda")
    data = {"coord": coord, "numbers": numbers, "cell": cell}
    res: dict = {"kernels": {}, "requests": {}, "checks": {}}
    launches = {name: 0 for name in counters()}

    # D and E with the new terms against their plain versions
    calc_ew = AIMNet2Calculator((params, cfg_ew), device="cuda")
    calc_lr = AIMNet2Calculator((params_lr, cfg_lr), device="cuda")
    sys_ew = calc_ew.prepare_system(data)
    log(f"[long_range] ewald-10k: eta {sys_ew.ewald_eta_static[0]:.4f} A, real-space cutoff "
        f"{sys_ew.ewald_r_static:.3f} A, {sys_ew.ewald_kpts.shape[0]} k-points, LR grid {sys_ew.lr_bins.nbins} "
        f"C={sys_ew.lr_bins.capacity}")
    _r, res["kernels"]["ewald-10k"] = phase_pair_kernels(calc_ew, sys_ew, "ewald-10k")
    res["exact_products"] = lr_exact_products(sys_ew)
    c_small, n_small, cell_small = build_box(N_CHECK, seed=1)
    sys_small = AIMNet2Calculator((params, cfg_ew), device="cuda").prepare_system(
        {"coord": c_small, "numbers": n_small, "cell": cell_small})
    log(f"[long_range] ewald-1200: real-space cutoff {sys_small.ewald_r_static:.3f} A in a "
        f"{float(cell_small[0, 0]):.2f} A cell (above half the side): LR grid {sys_small.lr_bins.nbins}")
    _r, res["kernels"]["ewald-1200"] = phase_pair_kernels(calc_ew, sys_small, "ewald-1200")
    _r, res["kernels"]["lr-heads-10k"] = phase_pair_kernels(calc_lr, calc_lr.prepare_system(data), "lr-heads-10k")
    del sys_ew, sys_small
    torch.cuda.empty_cache()

    # the requests
    conv = {"conv_stencil_forward": 3, "conv_stencil_backward": 3}
    one = {**conv, "pair_sweep_forward": 1, "pair_sweep_backward": 1}
    three = {**conv, "pair_sweep_forward": 3, "pair_sweep_backward": 3}
    for label, calc, per_request in (
        ("ewald-10k", calc_ew, one),
        ("pme-10k", AIMNet2Calculator((params, cfg_pme), device="cuda"), one),
        ("lr-heads-10k", calc_lr, three),
        ("nod2-10k", AIMNet2Calculator((params_nod2, cfg_nod2), device="cuda"), one),
    ):
        res["requests"][label] = phase_main_path(label, calc, coord, numbers, cell, per_request)
        for name, n in res["requests"][label]["launches"].items():
            launches[name] += n
        del calc
        torch.cuda.empty_cache()
    e_ew, e_pme = res["requests"]["ewald-10k"]["energies"][0], res["requests"]["pme-10k"]["energies"][0]
    limit = LR_PME_REL * max(1.0, abs(e_ew))
    log(f"[long_range] PME against Ewald on the 10k box: {e_pme:.6f} against {e_ew:.6f} eV, |dE| "
        f"{abs(e_pme - e_ew):.3e} (limit {limit:.3e})")
    if abs(e_pme - e_ew) > limit:
        raise SystemExit("FAIL: PME and Ewald disagree on the 10k box")
    res["pme_vs_ewald"] = {"ewald": e_ew, "pme": e_pme, "limit": limit}

    c500, n500, cell500 = build_box(500, seed=2)
    box500 = {"coord": c500, "numbers": n500, "cell": cell500}
    cfg_d3_ew = ewald_config(cfg_d3)
    none = {name: 0 for name in counters()}
    calc = AIMNet2Calculator((params_d3, cfg_d3_ew), device="cuda")
    res["requests"]["ewald-periodic-500"] = gas_request("ewald-periodic-500 wb97m-d3", calc, box500, True, none,
                                                        N_BUILT_GAS)
    if calc._prep_cache["system"].ewald_kpts is None:
        raise SystemExit("FAIL: ewald-periodic-500 ran without its Ewald discretisation")
    del calc

    # the card against the CPU (plain versions)
    res["checks"]["ewald-1200 charged"] = gas_card_vs_cpu(
        "ewald-1200 flagship, charge +1", params, cfg_ew,
        {"coord": c_small, "numbers": n_small, "cell": cell_small, "charge": 1.0}, True)
    res["checks"][f"pme-{CHECK_BOX}"] = phase_card_vs_cpu(f"pme-{CHECK_BOX} flagship", params, cfg_pme)
    res["checks"][f"lr-heads-{CHECK_BOX}"] = phase_card_vs_cpu(f"lr-heads-{CHECK_BOX}", params_lr, cfg_lr)
    res["checks"]["ewald-periodic-500"] = gas_card_vs_cpu("ewald-periodic-500 wb97m-d3", params_d3, cfg_d3_ew,
                                                          box500, True)

    # MD: the first 50 NVE steps at exact on the binned engine (the MD
    # setting's dt, 0.5 fs), then the same 25 fs at half the time step: the
    # random-weight Ewald potential collapses faster than the DSF one (its
    # Coulomb is undamped), and its NVE error at 0.5 fs is the integrator's,
    # falling as dt^2 (the ratio is printed); energy conservation is gated
    # at 0.25 fs
    md = MDConfig(**{**MD_SETTING, "thermostat": "nve", "precision": "exact"})
    system = md_system(coord, numbers, cell, torch.device("cuda"))
    peak = res["requests"]["ewald-10k"]["peak_bytes"]
    for key, dt, n_chunks in (("md", md.dt_fs, MD_WARM), ("md_half_dt", md.dt_fs / 2, 2 * MD_WARM)):
        drv = MDDriver(params, cfg_ew, system, dataclasses.replace(md, dt_fs=dt), seed=0, device="cuda")
        drv.state  # the initial forces, outside the window
        log(f"[md md-ewald-10k] dt {dt} fs; LR grid {drv.lr_grid.nbins} C={drv.lr_grid.capacity} at the "
            f"real-space cutoff {drv._ewald_rc:.3f} A + skin")
        res[key] = md_window(f"md-ewald-10k exact first {n_chunks * MD_CHUNK} NVE at {dt} fs", drv, one, peak,
                             n_chunks=n_chunks)
        for name, n in res[key]["launches"].items():
            launches[name] += n
        del drv
    drifts = (res["md"]["etot_drift"], res["md_half_dt"]["etot_drift"])
    log(f"[md md-ewald-10k] NVE |change| / |E| over 25 fs: {drifts[0]:.2e} at {md.dt_fs} fs, {drifts[1]:.2e} at "
        f"{md.dt_fs / 2} fs (ratio {drifts[0] / max(drifts[1], 1e-30):.2f}; an integrator's error falls 4x)")
    if drifts[1] > MD_NVE_DRIFT:
        raise SystemExit(f"FAIL: NVE total energy moved by more than {MD_NVE_DRIFT} of itself on md-ewald-10k")
    snaps = []
    for _ in range(2):
        drv = MDDriver(params, cfg_ew, system, md, seed=7, device="cuda")
        drv.run(2 * MD_CHUNK, chunk=MD_CHUNK)
        snaps.append(drv.snapshot())
        del drv
    if not all(np.array_equal(snaps[0][k], snaps[1][k]) for k in ("coord", "veloc", "cell")):
        raise SystemExit("FAIL: two Ewald MD drivers of one seed gave other coordinates after 50 steps")
    log("[md md-ewald-10k] two drivers of one seed give the same coordinates and velocities bit for bit "
        "after 50 steps")
    torch.cuda.empty_cache()

    res["hvp"] = lr_hvp_check(params, cfg_ew)
    res["launches"] = launches
    res["seconds"] = time.perf_counter() - t_phase
    log(f"[long_range] phase done in {res['seconds']:.1f} s")
    return res


ENS_MEMBERS = 4  # the released families ship four members (aimnet2 = aimnet2-wb97m-d3_{0..3})
ENS_BOX = 300  # atoms of the card-against-CPU box
SINGLE_MS_BEFORE_TILES = {"A": 0.369, "B": 1.079}  # A and B at G*F = 272 before column tiles (PERF.md's kernel table)
ENS_MD_STEPS = 30  # the timed and gated ensemble MD window: 15 fs, before the random potentials collapse
ENS_MD_CHECK_STEPS = 3  # ensemble MD steps card against CPU on the ENS_BOX box (its CPU side takes seconds a step)


def ensemble_params(make, n: int = ENS_MEMBERS):
    """``n`` members ``make(seed)`` (seeds 0..n-1), stacked; the config."""
    from aimnetcentral_tpu_torch.calculators import stack_params

    members = [make(seed) for seed in range(n)]
    return stack_params([p for p, _c in members]), members[0][1]


def ens_card_vs_cpu(label: str, params, cfg, data, binned_threshold: int) -> dict:
    """The fused ensemble on the card against the port's CPU run: energy
    within 1e-5 relative with the floor of one f32 rounding of every summed
    term (the largest member's), forces 1e-4 eV/A, ``energy_std`` within
    1e-5 of max(1, |E|); a repeated request on the card bit for bit."""
    import torch

    from aimnetcentral_tpu_torch.calculators import EnsembleCalculator
    from aimnetcentral_tpu_torch.models.bridge import params_to
    from aimnetcentral_tpu_torch.models.ensemble_fused import member_params

    calc = EnsembleCalculator((params, cfg), device="cuda", fused=True, binned_threshold=binned_threshold)
    system = calc.prepare_system(data)
    cfg_eff = calc._effective_cfg(system.cell is not None)
    floor = F32_EPS * max(energy_terms_abs(member_params(params, e), cfg_eff, system)
                          for e in range(params["afv"]["weight"].shape[0]))
    t0 = time.perf_counter()
    card = calc.eval(data, forces=True)
    torch.cuda.synchronize()
    t_card = time.perf_counter() - t0
    again = calc.eval(data, forces=True)
    for key in card:
        if not np.array_equal(card[key], again[key]):
            raise SystemExit(f"FAIL: a repeated ensemble request gave another {key} on {label}")
    t0 = time.perf_counter()
    cpu = EnsembleCalculator((params_to(params, torch.device("cpu")), cfg), device="cpu", fused=True,
                             binned_threshold=binned_threshold).eval(data, forces=True)
    t_cpu = time.perf_counter() - t0
    de = np.abs(card["energy"] - cpu["energy"])
    e_tol = np.maximum(REL_TOL * np.abs(cpu["energy"]), floor)
    df = float(np.abs(card["forces"] - cpu["forces"]).max())
    dstd = np.abs(card["energy_std"] - cpu["energy_std"])
    std_tol = REL_TOL * np.maximum(1.0, np.abs(cpu["energy"]))
    log(f"[ensemble check {label}] {calc._prep_cache['kind']} layout, {len(card['forces'])} atoms, "
        f"{params['afv']['weight'].shape[0]} members fused: largest |dE| {de.max():.3e} eV (limit "
        f"{e_tol.min():.3e}: 1e-5 relative, floor {floor:.3e}); max |dF| {df:.3e} eV/A (limit 1e-4); largest "
        f"|d energy_std| {dstd.max():.3e} (limit {std_tol.min():.3e}); energy_std {cpu['energy_std'].max():.4e} eV; "
        f"a repeat bit for bit (card {t_card:.2f} s, cpu {t_cpu:.2f} s)")
    if (de > e_tol).any() or df > 1e-4 or (dstd > std_tol).any():
        raise SystemExit(f"FAIL: the card and the CPU run disagree on {label}")
    return {"dE": float(de.max()), "dE_limit": float(e_tol.min()), "dF": df, "d_energy_std": float(dstd.max()),
            "card_s": t_card, "cpu_s": t_cpu}


def phase_ensemble(params, cfg, coord, numbers, cell, single_launches: dict, single_detail: dict) -> dict:
    """Ensembles at full width (``phase_ensemble``): four random flagship
    members (seeds 0-3) at the exact tier.  A and B at the fused forward's
    member-stacked widths (G*F = 1,024 and 1,088: column tiles) on the 10k
    request SR grid, with the plain, f64 and pair-count gates, beside the
    single model's G*F = 272 (``single_detail``: phase 3's A and B on the
    same grid); the member forms of D and E at E = 4 (DSF on the fused
    request's own LR grid, D3TS on lr-heads-10k's, the real-space Ewald sum
    on ewald-1200's grid, simple Coulomb on packed-8's molecule bins) under
    the same gates; ens4-flagship-10k requests, fused (A, B 3; D, E 1) and
    per member (A, B 12; D, E 4), as phase 4, the fused energy and forces
    against the per-member path within ``CHECK_ABS``; ensemble MD: each
    member alone and the ensemble for 25 fs of NVE (where each leaves
    ``MD_NVE_DRIFT``), then the first ENS_MD_STEPS steps timed and gated on
    it, with ``epot_std``; ENS_MD_CHECK_STEPS steps of ensemble MD on a
    300-atom box, card against CPU; the card against the CPU on a 300-atom
    box with the lr-heads set and Ewald, and on packed-8."""
    import torch

    from aimnetcentral_tpu_torch import constants
    from aimnetcentral_tpu_torch.calculators import AIMNet2Calculator, EnsembleCalculator
    from aimnetcentral_tpu_torch.dynamics import MDConfig, MDDriver
    from aimnetcentral_tpu_torch.kernels.build import LIBRARIES
    from aimnetcentral_tpu_torch.models import aimnet2_init
    from aimnetcentral_tpu_torch.models.ensemble_fused import member_params

    t_phase = time.perf_counter()
    n_e = ENS_MEMBERS
    data = {"coord": coord, "numbers": numbers, "cell": cell}
    ens_params, _c = ensemble_params(lambda s: (aimnet2_init(cfg, seed=s, device="cuda"), cfg))
    res: dict = {"kernels": {}, "requests": {}, "checks": {}}
    launches = {name: 0 for name in counters()}

    # A and B at the member-stacked widths, and DSF's member form, on the
    # fused request's SR and LR grids
    calc_f = EnsembleCalculator((ens_params, cfg), device="cuda", fused=True)
    sysb = calc_f.prepare_system(data)
    f1 = cfg.nfeature + cfg.num_charge_channels
    rows_ab, res["kernels"]["ab"] = phase_kernels(calc_f, sysb, "ens4 stacked", fs=(n_e * cfg.nfeature, n_e * f1))
    for key, idx in (("A", 0), ("B", 1)):
        st_row = single_detail[f"F{f1}"][key]
        log(f"[ensemble kernels] {key}: G*F = {16 * n_e * f1} {rows_ab[idx]['ms']:.3f} ms a launch against the "
            f"single model's G*F = {16 * f1} {st_row['ms']:.3f} ms on the same grid in this run (phase 3; before "
            f"column tiles {SINGLE_MS_BEFORE_TILES[key]:.3f} ms on an H100 80GB HBM3 at 700 W): "
            f"{rows_ab[idx]['ms'] / st_row['ms']:.2f} x")
    rows_de, res["kernels"]["ens4 flagship-10k"] = phase_pair_kernels(calc_f, sysb, "ens4 flagship-10k", members=n_e)
    del sysb
    for name, text in LIBRARIES.logs.items():
        lines = text.splitlines()
        for k, line in enumerate(lines):
            kernel = line.split("'")[1] if "Compiling entry function" in line else ""
            if "kernelILi17" in kernel or "Members" in kernel:
                info = "; ".join(x.strip().removeprefix("ptxas info    : ") for x in lines[k + 1:k + 4]
                                 if "registers" in x or "spill" in x)
                log(f"[ensemble kernels] ptxas {name} {kernel[:90]}: {info}")
    torch.cuda.empty_cache()

    # the other member forms at E = 4
    params_lr, cfg_lr = lr_heads_model(cfg)
    calc_lr = AIMNet2Calculator((params_lr, cfg_lr), device="cuda")
    c_small, n_small, cell_small = build_box(N_CHECK, seed=1)
    calc_ew = AIMNet2Calculator((params, ewald_config(cfg)), device="cuda")
    sys_small = calc_ew.prepare_system({"coord": c_small, "numbers": n_small, "cell": cell_small})
    batch8 = [gas_cluster(n, seed=10 + k) for k, n in enumerate(GAS_BATCH)]
    calc_packed = AIMNet2Calculator((params, cfg), device="cuda", binned_threshold=512)
    for label, calc, system, only in (
        ("ens4 lr-heads-10k", calc_lr, calc_lr.prepare_system(data), ("d3ts_multi",)),
        ("ens4 ewald-1200", calc_ew, sys_small, None),
        ("ens4 packed-8", calc_packed, calc_packed.prepare_system(batch8), None),
    ):
        _rows, res["kernels"][label] = phase_pair_kernels(calc, system, label, members=n_e, only=only)
    del sys_small
    torch.cuda.empty_cache()

    # the requests: fused and per member
    conv = {"conv_stencil_forward": 3, "conv_stencil_backward": 3}
    fused_per = {**conv, "pair_sweep_forward": 1, "pair_sweep_backward": 1}
    member_per = {k: n_e * v for k, v in fused_per.items()}
    res["requests"]["ens4-flagship-10k fused"] = phase_main_path("ens4-flagship-10k fused", calc_f, coord, numbers,
                                                                 cell, fused_per)
    calc_m = EnsembleCalculator((ens_params, cfg), device="cuda")
    res["requests"]["ens4-flagship-10k per member"] = phase_main_path("ens4-flagship-10k per member", calc_m, coord,
                                                                      numbers, cell, member_per)
    for name, n in res["requests"]["ens4-flagship-10k per member"]["launches"].items():
        launches[name] += n  # the single-model kernels' launches
    log(f"[ensemble] launches a request: fused {fused_per}, per member {member_per}, the single-model "
        f"flagship's {single_launches}")
    got = calc_f.eval(data, forces=True)
    ref = calc_m.eval(data, forces=True)
    diffs = {"energy": float(np.abs(got["energy"] - ref["energy"]).max()),
             "forces": float(np.abs(got["forces"] - ref["forces"]).max())}
    log(f"[ensemble] ens4-flagship-10k fused against per member: |dE| {diffs['energy']:.3e} eV, max |dF| "
        f"{diffs['forces']:.3e} eV/A (limits {CHECK_ABS['energy']:.1e}, {CHECK_ABS['forces']:.1e}); E "
        f"{ref['energy'][0]:.6f} eV, energy_std {ref['energy_std'][0]:.6f} / {got['energy_std'][0]:.6f} eV")
    if over_limits(diffs, CHECK_ABS):
        raise SystemExit(f"FAIL: the fused ensemble and the per-member path disagree: {over_limits(diffs, CHECK_ABS)}")
    res["fused_vs_per_member"] = diffs
    del calc_m
    torch.cuda.empty_cache()

    # ensemble MD at exact, NVE.  The random members' potentials are
    # unbounded below: from this box each member alone, and their mean,
    # falls into a collapse within 20-40 fs, where the forces of colliding
    # atoms outrun any time step.  25 fs of each show where each one's
    # total energy first leaves MD_NVE_DRIFT; the timed and gated window
    # is the first ENS_MD_STEPS steps, before any of them collapses.
    md = MDConfig(**{**MD_SETTING, "thermostat": "nve", "precision": "exact"})
    res["md_collapse_step"] = {}
    for label, p, ens in ([(f"member {s} alone (seed {s})", member_params(ens_params, s), False)
                           for s in range(1, n_e)] + [("ens4 fused", ens_params, True)]):
        drv = MDDriver(p, cfg, md_system(coord, numbers, cell, torch.device("cuda")), md, ensemble=ens, seed=0,
                       device="cuda")
        obs = drv.run(2 * MD_CHUNK, chunk=MD_CHUNK)
        etot = obs["epot"].astype(np.float64) + 1.5 * len(numbers) * constants.kB * obs["temperature"]
        change = np.abs(etot - etot[0]) / abs(etot[0])
        beyond = np.nonzero(change > MD_NVE_DRIFT)[0]
        first = int(beyond[0]) + 1 if len(beyond) else None
        res["md_collapse_step"][label] = first
        log(f"[md ens4-flagship-10k] {label}, 50 NVE steps at "
            f"{md.dt_fs} fs: NVE |change| / |E| {change[ENS_MD_STEPS - 1]:.2e} after {ENS_MD_STEPS} steps, "
            f"{change[-1]:.2e} after 50; first step beyond {MD_NVE_DRIFT}: {first}; temperature "
            f"{obs['temperature'][0]:.0f} -> {obs['temperature'].max():.0f} K at most")
        if ens:
            std = obs["epot_std"][:ENS_MD_STEPS]
            if not (np.isfinite(std).all() and (std > 0).all()):
                raise SystemExit("FAIL: ensemble MD's epot_std is not finite and positive")
            log(f"[md ens4-flagship-10k] epot_std {std[0]:.6f} -> {std[-1]:.6f} eV over the first {ENS_MD_STEPS} "
                f"steps")
        del drv
    drv = MDDriver(ens_params, cfg, md_system(coord, numbers, cell, torch.device("cuda")), md, ensemble=True,
                   seed=0, device="cuda")
    drv.state  # the initial forces, outside the window
    name = f"ens4-flagship-10k exact first {ENS_MD_STEPS} NVE"
    res["md"] = md_window(name, drv, fused_per, res["requests"]["ens4-flagship-10k fused"]["peak_bytes"],
                          n_chunks=2, chunk=ENS_MD_STEPS // 2)
    if res["md"]["etot_drift"] > MD_NVE_DRIFT:
        raise SystemExit(f"FAIL: NVE total energy moved by more than {MD_NVE_DRIFT} of itself on {name}")
    del drv
    torch.cuda.empty_cache()
    res["md_check"] = phase_md_card_vs_cpu("ens4 flagship", ens_params, cfg, ensemble=True, n_box=ENS_BOX,
                                           steps=ENS_MD_CHECK_STEPS)

    # the card against the CPU: a 300-atom box with the lr-heads set and
    # Ewald (SRRep, DispParam, D3TS), binned; packed-8, molecule bins
    ens_lr, cfg_lr = ensemble_params(lambda s: lr_heads_model(cfg, seed=s))
    c3, n3, cell3 = build_box(ENS_BOX, seed=3)
    res["checks"]["ens4-lr-heads-300"] = ens_card_vs_cpu(
        "ens4 lr-heads-300 ewald", ens_lr, ewald_config(cfg_lr), {"coord": c3, "numbers": n3, "cell": cell3},
        binned_threshold=256)
    res["checks"]["ens4-packed-8"] = ens_card_vs_cpu("ens4 packed-8 flagship", ens_params, cfg, batch8,
                                                     binned_threshold=512)

    # the record's rows: the column-tiled A and B, and the member forms of D
    # and E as the fused request and MD launch them (DSF on the flagship's
    # LR grid); the other forms' times are in the phase's detail
    fused_launches = {k: res["requests"]["ens4-flagship-10k fused"]["launches"][k] + res["md"]["launches"][k]
                      for k in launches}
    res["rows"] = []
    for row in rows_ab:
        res["rows"].append({**row, "name": f"{row['name']} (column tiles, G*F = {16 * n_e * f1})",
                            "launches": fused_launches[row["name"]],
                            "launches_per_md_step": {"ens4-flagship-10k exact": res["md"]["launches_per_step"][row["name"]]}})
    for row in rows_de:
        res["rows"].append({**row, "name": f"{row['name']} (member form, E = {n_e})",
                            "launches": fused_launches[row["name"]],
                            "launches_per_md_step": {"ens4-flagship-10k exact": res["md"]["launches_per_step"][row["name"]]}})
    res["launches"] = launches
    res["seconds"] = time.perf_counter() - t_phase
    log(f"[ensemble] phase done in {res['seconds']:.1f} s")
    return res


INT_SYMBOLS = {1: "H", 6: "C", 7: "N", 8: "O"}
INT_ASE_REQUESTS = 10  # adapter requests on flagship-10k, each beside a direct one on the same moved input
INT_TS_CALLS = 5  # timed TorchSim calls a state, each beside a direct request


def voigt(stress) -> np.ndarray:
    """A (3, 3) stress symmetrised, in ASE's Voigt order xx, yy, zz, yz, xz, xy."""
    s = np.asarray(stress, dtype=np.float64)
    s = 0.5 * (s + s.T)
    return np.array([s[0, 0], s[1, 1], s[2, 2], s[1, 2], s[0, 2], s[0, 1]])


def write_xyz(path: str, coord, numbers) -> None:
    with open(path, "w") as fh:
        fh.write(f"{len(numbers)}\n\n")
        fh.writelines(f"{INT_SYMBOLS[int(z)]} {x:.8f} {y:.8f} {w:.8f}\n" for z, (x, y, w) in zip(numbers, coord))


def write_cif(path: str, coord, numbers, cell) -> None:
    """A P1 CIF of a box with an orthorhombic cell."""
    frac = np.asarray(coord, np.float64) @ np.linalg.inv(np.asarray(cell, np.float64))
    a, b, c = np.diag(cell)
    lines = ["data_box", f"_cell_length_a {a:.8f}", f"_cell_length_b {b:.8f}", f"_cell_length_c {c:.8f}",
             "_cell_angle_alpha 90", "_cell_angle_beta 90", "_cell_angle_gamma 90", "loop_",
             "_atom_site_type_symbol", "_atom_site_fract_x", "_atom_site_fract_y", "_atom_site_fract_z"]
    lines += [f"{INT_SYMBOLS[int(z)]} {x:.10f} {y:.10f} {w:.10f}" for z, (x, y, w) in zip(numbers, frac)]
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")


def counted(fn):
    """``fn()``'s result and every kernel's launches while it ran (read as
    differences: the phase's own count runs on underneath)."""
    wrappers = counters()
    before = read_counts(wrappers)
    out = fn()
    return out, {name: n - before[name] for name, n in read_counts(wrappers).items()}


def gate(ok: bool, msg: str) -> None:
    if not ok:
        raise SystemExit(f"FAIL: {msg}")


def int_ase(calc, coord, numbers, cell, ase_mod) -> dict:
    """AIMNet2ASE on flagship-10k against direct requests, and get_hessian
    on mol-113."""
    import torch
    from torch_fakes import FakeAtoms, RecordingCalc

    rng = np.random.default_rng(21)
    inputs = [(coord + rng.normal(scale=0.05, size=coord.shape)).astype(np.float32) for _ in range(INT_ASE_REQUESTS)]
    spy = RecordingCalc(calc)
    ase_calc = ase_mod.AIMNet2ASE(spy)
    per = {"conv_stencil_forward": 3, "conv_stencil_backward": 3, "pair_sweep_forward": 1, "pair_sweep_backward": 1}
    t_direct, t_adapter, t_inner, diffs = [], [], [], {"energy": 0.0, "forces": 0.0, "stress": 0.0}
    launches = {"direct": {n: 0 for n in per}, "adapter": {n: 0 for n in per}}
    for x in inputs:
        data = {"coord": x, "numbers": numbers, "charge": 0.0, "cell": cell}
        t0 = time.perf_counter()
        direct, n_direct = counted(lambda: calc.eval(data, forces=True, stress=True))
        t_direct.append(time.perf_counter() - t0)
        atoms = FakeAtoms(x.astype(np.float64), numbers, cell=cell.astype(np.float64), pbc=True)
        t0 = time.perf_counter()
        _none, n_adapter = counted(lambda: ase_calc.calculate(atoms, properties=("energy", "forces", "stress")))
        t_adapter.append(time.perf_counter() - t0)
        t_inner.append(spy.seconds[-1])
        gate(calc._prep_cache["kind"] == "binned", "the ASE request on flagship-10k left the binned layout")
        r = ase_calc.results
        diffs["energy"] = max(diffs["energy"], abs(r["energy"] - float(direct["energy"][0])))
        diffs["forces"] = max(diffs["forces"], float(np.abs(r["forces"] - direct["forces"]).max()))
        diffs["stress"] = max(diffs["stress"], float(np.abs(r["stress"] - voigt(direct["stress"][0])).max()))
        for n in per:
            launches["direct"][n] += n_direct[n]
            launches["adapter"][n] += n_adapter[n]
    log(f"[integrations ase] flagship-10k, {INT_ASE_REQUESTS} adapter requests (energy, forces, stress) against "
        f"{INT_ASE_REQUESTS} direct eval(forces=True, stress=True) on the same moved inputs: "
        + ", ".join(f"max |d{k}| {v:.3e} (limit {CHECK_ABS[k]:.0e})" for k, v in diffs.items()))
    gate(not over_limits(diffs, CHECK_ABS), f"the ASE adapter and eval disagree on flagship-10k: {diffs}")
    for path, counts in launches.items():
        want = {n: k * INT_ASE_REQUESTS for n, k in per.items()}
        gate(counts == want, f"the {path} path launched {counts} over {INT_ASE_REQUESTS} requests, want {want}")
    added = [a - i for a, i in zip(t_adapter, t_inner)]
    res = {"diffs": diffs, "launches": launches, "direct_ms": float(np.median(t_direct)) * 1e3,
           "adapter_ms": float(np.median(t_adapter)) * 1e3, "added_host_ms": float(np.median(added)) * 1e3}
    log(f"[integrations ase] launches over the {INT_ASE_REQUESTS} adapter requests {launches['adapter']} (as the "
        f"direct ones); median ms a request: direct {res['direct_ms']:.2f}, adapter {res['adapter_ms']:.2f}; the "
        f"adapter's added host ms (its wall time less the calculator's): median {res['added_host_ms']:.3f}, "
        f"max {max(added) * 1e3:.3f}")

    mol = gas_cluster(113, seed=1)
    t0 = time.perf_counter()
    h, n_h = counted(lambda: ase_calc.get_hessian(FakeAtoms(mol["coord"].astype(np.float64), mol["numbers"])))
    t_h = time.perf_counter() - t0
    direct_h = calc.eval({"coord": mol["coord"], "numbers": mol["numbers"], "charge": 0.0}, hessian=True)["hessian"]
    n3 = 3 * len(mol["numbers"])
    ref = np.asarray(direct_h, dtype=np.float64).reshape(n3, n3)
    asym = float(np.abs(h - h.T).max() / np.abs(h).max())
    gate(not any(n_h.values()), f"get_hessian launched kernels: {n_h}")
    gate(h.shape == (n3, n3) and np.isfinite(h).all(), f"get_hessian gave {h.shape}")
    gate(np.array_equal(h, ref), f"get_hessian differs from eval(hessian=True) by {np.abs(h - ref).max():.3e}")
    gate(asym <= SO_SYM_REL, f"get_hessian's asymmetry {asym:.3e} over {SO_SYM_REL:.0e}")
    torch.cuda.synchronize()
    log(f"[integrations ase] get_hessian on mol-113: ({n3}, {n3}), equal to eval(hessian=True) reshaped bit for "
        f"bit, max |H - H^T| {asym:.2e} of max |H| (limit {SO_SYM_REL:.0e}), no launch, {t_h:.2f} s")
    res.update(hessian_s=t_h, hessian_asym=asym, hessian_launches=n_h)
    return res


def int_pysis(calc, ase_mod) -> dict:
    """AIMNet2Pysis on mol-113: forces in Hartree/Bohr against the direct
    request's, and a repeat served from the adapter's cache."""
    from aimnetcentral_tpu_torch import constants
    from torch_fakes import RecordingCalc

    mol = gas_cluster(113, seed=1)
    elem = [INT_SYMBOLS[int(z)] for z in mol["numbers"]]
    coords_bohr = mol["coord"].astype(np.float64).reshape(-1) / constants.Bohr
    spy = RecordingCalc(calc)
    pysis = ase_mod.AIMNet2Pysis(spy)
    got = pysis.get_forces(elem, coords_bohr)
    data = {"coord": (coords_bohr.reshape(-1, 3) * constants.Bohr).astype(np.float32), "numbers": mol["numbers"],
            "charge": 0.0, "mult": 1.0}
    direct = calc.eval(data, forces=True)
    scale = constants.Bohr / constants.Hartree
    df = float(np.abs(got["forces"] - direct["forces"].reshape(-1) * scale).max())
    de = abs(got["energy"] - float(direct["energy"][0]) / constants.Hartree)
    gate(df <= CHECK_ABS["forces"] * scale and de <= CHECK_ABS["energy"] / constants.Hartree,
         f"the PySisyphus forces disagree with eval's: |dF| {df:.3e} Eh/Bohr, |dE| {de:.3e} Eh")
    n_calls = len(spy.calls)
    again, n_again = counted(lambda: pysis.get_forces(elem, coords_bohr))
    gate(len(spy.calls) == n_calls and not any(n_again.values()), "a repeated PySisyphus request reached the card")
    gate(np.array_equal(again["forces"], got["forces"]), "a cached PySisyphus request changed its forces")
    log(f"[integrations pysis] mol-113 forces (Hartree/Bohr) against eval's times Bohr/Hartree: max |dF| {df:.3e} "
        f"(limit {CHECK_ABS['forces'] * scale:.2e}), |dE| {de:.3e} Eh; a repeat is served from the cache, no launch")
    return {"dF": df, "dE": de}


def int_torchsim(label: str, calc, state, stress: bool, per_call: dict, kind: str) -> dict:
    """AIMNet2TorchSim on a state on the card: layout, launches, results
    against a direct ``eval`` on the same (B, N, 3) data, outputs on the
    card in JAX's dtypes; ms a call and the host round trip."""
    import torch

    from aimnetcentral_tpu_torch.calculators.torchsim_adapter import AIMNet2TorchSim
    from torch_fakes import RecordingCalc

    spy = RecordingCalc(calc)
    adapter = AIMNet2TorchSim(spy, compute_stress=stress)
    adapter(state)  # builds the layout
    out, n_out = counted(lambda: adapter(state))
    gate(calc._prep_cache["kind"] == kind, f"{label} ran on the {calc._prep_cache['kind']} layout, not {kind}")
    gate(n_out == per_call, f"{label} launched {n_out} a call, want {per_call}")
    data = adapter._state_to_data(state)
    direct, n_direct = counted(lambda: calc.eval(data, forces=True, stress=stress))
    gate(n_direct == n_out, f"{label}: a direct request launched {n_direct}, the adapter {n_out}")
    diffs = {"energy": float(np.abs(out["energy"].cpu().numpy() - direct["energy"]).max()),
             "forces": float(np.abs(out["forces"].cpu().numpy() - direct["forces"]).max())}
    if stress:
        diffs["stress"] = float(np.abs(out["stress"].cpu().numpy() - np.swapaxes(direct["stress"], -1, -2)).max())
    gate(not over_limits(diffs, CHECK_ABS), f"{label}: the TorchSim adapter and eval disagree: {diffs}")
    for k, v in out.items():
        gate(v.device == state.positions.device and v.dtype == torch.float64,
             f"{label}: {k} came back on {v.device} as {v.dtype}")
    t_adapter, t_inner, t_direct = [], [], []
    for _ in range(INT_TS_CALLS):
        t0 = time.perf_counter()
        adapter(state)
        torch.cuda.synchronize()
        t_adapter.append(time.perf_counter() - t0)
        t_inner.append(spy.seconds[-1])
        t0 = time.perf_counter()
        calc.eval(data, forces=True, stress=stress)
        t_direct.append(time.perf_counter() - t0)
    trip = [a - i for a, i in zip(t_adapter, t_inner)]
    res = {"layout": kind, "launches": n_out, "diffs": diffs, "ms": float(np.median(t_adapter)) * 1e3,
           "direct_ms": float(np.median(t_direct)) * 1e3, "round_trip_ms": float(np.median(trip)) * 1e3}
    log(f"[integrations torchsim {label}] {kind} layout, launches a call {n_out} (as a direct request); outputs on "
        f"{state.positions.device} in float64; " + ", ".join(f"max |d{k}| {v:.3e}" for k, v in diffs.items())
        + f"; ms a call (median of {INT_TS_CALLS}): adapter {res['ms']:.2f}, direct {res['direct_ms']:.2f}, host "
        f"round trip {res['round_trip_ms']:.3f} (max {max(trip) * 1e3:.3f})")
    return res


def int_cli(artifact: str, work: str) -> dict:
    """The CLI's serving commands on the card on the wb97m-d3 artifact,
    each held against the direct API: through click's test runner, or the
    plain command bodies where click is not installed."""
    import torch

    from aimnetcentral_tpu_torch import cli
    from aimnetcentral_tpu_torch.dynamics import MDConfig, MDDriver, fire_relax, frequencies_from_calculator
    from aimnetcentral_tpu_torch.dynamics.neb import neb as neb_band
    from aimnetcentral_tpu_torch.io import read_cif, read_xyz
    from aimnetcentral_tpu_torch.kernels.build import SOURCES

    try:
        from click.testing import CliRunner
    except ImportError:
        CliRunner = None
        log("[integrations cli] click is not installed here: the commands run through their plain bodies "
            "(cli.run_*), which print the same text")

    def command(name: str, args: list, body, **kw) -> str:
        t0 = time.perf_counter()
        if CliRunner is not None:
            r = CliRunner().invoke(cli.cli, [name, *map(str, args)])
            if r.exit_code != 0:
                import traceback

                if r.exc_info:
                    traceback.print_exception(*r.exc_info)
                raise SystemExit(f"FAIL: `{name}` exited {r.exit_code}: {r.output[-400:]}")
            text = r.output
        else:
            out = body(**kw)
            text = "\n".join(out) + "\n" if isinstance(out, list) else json.dumps(out) + "\n"
        seconds[name] = seconds.get(name, 0.0) + time.perf_counter() - t0
        return text

    seconds: dict = {}
    res: dict = {"click": CliRunner is not None}
    mol = gas_cluster(113, seed=1)
    mol_xyz = os.path.join(work, "mol-113.xyz")
    write_xyz(mol_xyz, mol["coord"], mol["numbers"])
    prod = {**mol, "coord": mol["coord"] + np.random.default_rng(5).normal(scale=0.15, size=mol["coord"].shape)}
    prod_xyz = os.path.join(work, "mol-113-moved.xyz")
    write_xyz(prod_xyz, prod["coord"], prod["numbers"])
    box_c, numbers_c, cell_c = build_box(N_CHECK, seed=1)
    box_cif, box_xyz = os.path.join(work, "box-1200.cif"), os.path.join(work, "box-1200.xyz")
    write_cif(box_cif, box_c, numbers_c, cell_c)
    write_xyz(box_xyz, box_c, numbers_c)
    L = float(cell_c[0, 0])

    def direct_calc():
        return cli._load_calc(artifact, device="cuda")[0]

    # sp on mol-113 (xyz) and on the box (CIF): energy to the printed digits
    mc, mz = read_xyz(mol_xyz)
    for label, path, data in (("mol-113", mol_xyz, {"coord": mc, "numbers": mz, "charge": 0.0}),
                              ("box-1200", box_cif, None)):
        if data is None:
            s = read_cif(path)
            data = {"coord": s["coord"], "numbers": s["numbers"], "charge": 0.0, "cell": s["cell"]}
        text, n_cli = counted(lambda: command("sp", [artifact, path], cli.run_sp, model=artifact, xyz=path))
        calc = direct_calc()
        ref, n_ref = counted(lambda: calc.eval(data, forces=True, stress="cell" in data))
        printed = text.split("energy (eV):")[1].split()[0]
        want = f"{ref['energy'][0]:.6f}"
        gate(printed == want, f"`sp` on {label} printed {printed}, eval gives {want}")
        gate(n_cli == n_ref, f"`sp` on {label} launched {n_cli}, a direct request {n_ref}")
        res[f"sp {label}"] = {"energy": printed, "launches": n_cli}
        log(f"[integrations cli] sp {label}: E {printed} eV as eval's, launches {n_cli} (as a direct request)"
            + (", stress printed" if "stress" in text else ""))

    # md on the box: zero-temperature NVE, against MDDriver on the same System
    md_args = ["--thermostat", "nve", "--temperature", 0, "--steps", 20, "--chunk", 10, "--cell", L]
    text, n_cli = counted(lambda: command("md", [artifact, box_xyz, *md_args], cli.run_md, model=artifact,
                                          xyz=box_xyz, steps=20, chunk=10, temperature=0.0, thermostat="nve", cell=L))
    got = json.loads(text.strip().splitlines()[-1])
    calc = direct_calc()
    bc, bz = read_xyz(box_xyz)
    system = calc.prepare_system({"coord": bc, "numbers": bz, "cell": np.eye(3, dtype=np.float32) * L})
    gate(calc._prep_cache["kind"] == "binned", "the box's md System is not on the binned layout")
    drv = MDDriver(calc.params, calc.cfg, system, MDConfig(dt_fs=0.5, temperature_K=0.0, thermostat="nve"),
                   device=calc.device)
    obs, n_ref = counted(lambda: drv.run(20, chunk=10))
    de = abs(got["final_epot_eV"] - float(obs["epot"][-1]))
    gate(de <= CHECK_ABS["energy"], f"`md` final_epot_eV {got['final_epot_eV']} against MDDriver's {obs['epot'][-1]}")
    gate(n_cli == n_ref and n_cli["conv_stencil_forward"] > 0, f"`md` launched {n_cli}, MDDriver {n_ref}")
    res["md box-1200"] = {"final_epot_eV": got["final_epot_eV"], "dE": de, "launches": n_cli}
    log(f"[integrations cli] md box-1200 (NVE, 0 K, 20 steps, --cell {L:.4f}): final_epot_eV "
        f"{got['final_epot_eV']:.6f}, MDDriver on the calculator's binned System {float(obs['epot'][-1]):.6f}, "
        f"|dE| {de:.3e} (limit {CHECK_ABS['energy']:.0e}); launches {n_cli} (as MDDriver's)")

    # relax on mol-113: FIRE's info dict
    text, _n = counted(lambda: command("relax", [artifact, mol_xyz, "--max-steps", 20], cli.run_relax,
                                       model=artifact, xyz=mol_xyz, max_steps=20))
    got = json.loads(text.strip().splitlines()[-1])
    calc = direct_calc()
    _relaxed, ref = fire_relax(calc.params, calc.cfg, calc.prepare_system({"coord": mc, "numbers": mz}),
                               fmax=0.05, max_steps=20)
    gate(got == json.loads(json.dumps(ref)), f"`relax` printed {got}, fire_relax gives {ref}")
    res["relax mol-113"] = got
    log(f"[integrations cli] relax mol-113 --max-steps 20: {got} (as fire_relax)")

    # freq on mol-113: frequencies against frequencies_from_calculator
    text, n_cli = counted(lambda: command("freq", [artifact, mol_xyz, "--n-modes", 6], cli.run_freq, model=artifact,
                                          xyz=mol_xyz, n_modes=6))
    got = json.loads(text.strip().splitlines()[-1])
    freqs, _modes = frequencies_from_calculator(direct_calc(), {"coord": mc, "numbers": mz, "charge": 0.0})
    dfreq = max(float(np.abs(np.asarray(got["lowest_cm1"]) - np.round(freqs[:6], 2)).max()),
                abs(got["highest_cm1"] - round(float(freqs[-1]), 2)))
    gate(dfreq <= 1e-3 and not any(n_cli.values()), f"`freq` off by {dfreq} cm^-1, launches {n_cli}")
    res["freq mol-113"] = {**got, "d_cm1": dfreq}
    log(f"[integrations cli] freq mol-113 --n-modes 6: lowest {got['lowest_cm1']}, highest {got['highest_cm1']} "
        f"cm^-1, within {dfreq:.1e} of frequencies_from_calculator (limit 1e-3), no launch")

    # a short NEB between mol-113 and a moved copy
    neb_args = ["--n-images", 5, "--max-steps", 5]
    text, _n = counted(lambda: command("neb", [artifact, mol_xyz, prod_xyz, *neb_args], cli.run_neb, model=artifact,
                                       reactant_xyz=mol_xyz, product_xyz=prod_xyz, n_images=5, max_steps=5))
    got = json.loads(text.strip().splitlines()[-1])
    calc = direct_calc()
    pc, pz = read_xyz(prod_xyz)
    _band, energies, info = neb_band(calc.params, calc.cfg, {"coord": mc, "numbers": mz, "charge": 0.0},
                                     {"coord": pc, "numbers": pz, "charge": 0.0}, n_images=5, device=calc.device,
                                     max_steps=5)
    e = energies.cpu().numpy().astype(np.float64)
    dbar = abs(got["barrier_eV"] - round(float(e.max() - e[0]), 6))
    gate(got["steps"] == info["steps"] and got["i_ts"] == info["i_ts"] and dbar <= CHECK_ABS["energy"],
         f"`neb` printed {got}, neb gives steps {info['steps']}, i_ts {info['i_ts']}, barrier {e.max() - e[0]}")
    res["neb mol-113"] = got
    log(f"[integrations cli] neb mol-113 (5 images, 5 iterations): barrier {got['barrier_eV']} eV, i_ts "
        f"{got['i_ts']}, as neb()")

    text = command("info", [], cli.run_info)
    gate("cuda available: True" in text and f"{len(SOURCES)} of {len(SOURCES)}" in text, f"`info` printed {text}")
    res["info"] = text.strip().splitlines()
    for line in res["info"]:
        log(f"[integrations cli] info: {line}")
    torch.cuda.synchronize()
    res["seconds"] = seconds
    log("[integrations cli] seconds by command: " + ", ".join(f"{k} {v:.2f}" for k, v in seconds.items()))
    return res


def int_observables() -> dict:
    """tools/validate_torch.py's model on the card against the committed
    baseline and against the port's CPU dump."""
    import importlib.util

    from aimnetcentral_tpu_torch.validation import compare_observables, dump_observables

    spec = importlib.util.spec_from_file_location("validate_torch", os.path.join(ROOT, "tools", "validate_torch.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    limits = dict(energy_atol=tool.ENERGY_ATOL, force_atol=tool.FORCE_ATOL, charge_atol=tool.CHARGE_ATOL)
    card, n_card = counted(lambda: dump_observables(tool.build_calculator("cuda")))
    cpu = dump_observables(tool.build_calculator("cpu"))
    res = {}
    for label, ref in (("the committed baseline", tool.BASELINE), ("the CPU", cpu)):
        ok, report = compare_observables(ref, card, **limits)
        for line in report.splitlines():
            log(f"[integrations observables] card against {label}: {line}")
        gate(ok, f"the validation model's card dump fails against {label}")
        res[label] = report
    gate(not any(n_card.values()), f"the validation model launched kernels: {n_card}")
    return res


def phase_integrations(calc, calc_d3, coord, numbers, cell, artifact: str) -> dict:
    """The integrations on the card (``phase_integrations``): the ASE
    adapter on flagship-10k (ten requests against ten direct ones on the
    same moved inputs: energy, forces and the symmetrised stress within
    ``CHECK_ABS``, A, B 3 and D, E 1 a request, the adapter's added host
    time) and its ``get_hessian`` on mol-113 (bit for bit
    ``eval(hessian=True)`` reshaped, symmetric, no launch); PySisyphus on
    mol-113 (forces times Bohr/Hartree, a repeat from the cache, no
    launch); TorchSim on packed-32x113 (wb97m-d3, molecule bins, A, B, D,
    E 3) and a 1,200-atom periodic state with stress (binned, A, B 3 and D,
    E 1), positions on the card (launches as a direct request, results
    within ``CHECK_ABS`` of a direct ``eval`` on the same (B, N, 3) data,
    outputs on the card in float64, ms a call and the host round trip);
    the CLI's ``sp`` (mol-113 xyz, the box as CIF), ``md`` (NVE at 0 K on
    the box with ``--cell``), ``relax``, ``freq``, ``neb`` and ``info`` on
    the wb97m-d3 artifact, each against the direct API; the validation
    model's dump on the card against the committed baseline and the CPU.
    The fakes of ASE and of a TorchSim state are tests/torch_fakes.py's."""
    import torch

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from torch_fakes import FakeSimState, fake_ase

    t_phase = time.perf_counter()
    wrappers = reset_counts()
    res: dict = {}
    with fake_ase("aimnetcentral_tpu_torch.calculators.ase_adapter") as (ase_mod,):
        res["ase"] = int_ase(calc, coord, numbers, cell, ase_mod)
        res["pysis"] = int_pysis(calc, ase_mod)

    batch = [gas_cluster(113, seed=200 + k) for k in range(32)]
    dev = torch.device("cuda")
    state = FakeSimState(
        positions=torch.tensor(np.concatenate([m["coord"] for m in batch]), device=dev),
        atomic_numbers=torch.tensor(np.concatenate([m["numbers"] for m in batch]), device=dev),
        system_idx=torch.tensor(np.repeat(np.arange(32), 113), device=dev),
    )
    three = {n: 3 for n in counters()}
    res["torchsim packed-32x113"] = int_torchsim("packed-32x113", calc_d3, state, False, three, "packed")
    box_c, numbers_c, cell_c = build_box(N_CHECK, seed=1)
    state = FakeSimState(positions=torch.tensor(box_c, device=dev), atomic_numbers=torch.tensor(numbers_c, device=dev),
                         cell=torch.tensor(cell_c.T.copy(), device=dev), pbc=True)
    one = {**three, "pair_sweep_forward": 1, "pair_sweep_backward": 1}
    res["torchsim periodic-1200"] = int_torchsim("periodic-1200", calc, state, True, one, "binned")

    with tempfile.TemporaryDirectory() as work:
        res["cli"] = int_cli(artifact, work)
    res["observables"] = int_observables()
    launches = read_counts(wrappers)
    res["launches"] = launches
    res["seconds"] = time.perf_counter() - t_phase
    log(f"[integrations] launches in the phase {launches}; phase done in {res['seconds']:.1f} s")
    return res


TRAIN_SIZES = (16, 24, 32, 48)  # atoms a cluster, one size group each
TRAIN_PER_SIZE = 64  # training clusters a group: 256 in all
TRAIN_VAL_PER_SIZE = 16  # validation clusters a group
TRAIN_BATCH = 64  # molecules a batch
TRAIN_CHECK_SIZE, TRAIN_CHECK_MOLS = 32, 8  # the card-against-CPU batch
TRAIN_TIMED_SIZE = 32  # the timed steps' size group (64 molecules, C = 32)
TRAIN_TIMED = 10  # timed steps a tier
# the gradient gate, per leaf: this times the CPU f32 step's own error
# against f64 (relative to the leaf's largest |g|), or times the median
# leaf's where that is larger
TRAIN_NOISE_FACTOR = 10.0
# launches a train step on molecule bins (flagship heads: simple Coulomb):
# A in the forward; B's constants' build in the forces and in the parameter
# gradient's first order; D in the forward, E in the forces and in the
# energy term's first order
TRAIN_PER_STEP = {"conv_stencil_forward": 3, "conv_stencil_backward": 0, "conv_stencil_backward_constants": 6,
                  "pair_sweep_forward": 1, "pair_sweep_backward": 2}
# a validation batch (forces, no parameter gradient)
TRAIN_PER_VAL = {"conv_stencil_forward": 3, "conv_stencil_backward": 3, "conv_stencil_backward_constants": 0,
                 "pair_sweep_forward": 1, "pair_sweep_backward": 1}


def train_counters() -> dict:
    """``counters()`` and kernel B's constants' build."""
    from aimnetcentral_tpu_torch.kernels import conv_stencil as cs

    return {**counters(), "conv_stencil_backward_constants": cs.conv_stencil_backward_constants}


def train_clusters(size: int, count: int, seed: int) -> list[dict]:
    return [gas_cluster(size, seed=seed + k) for k in range(count)]


def label_groups(teacher, groups: dict[int, list[dict]]) -> dict[int, dict]:
    """Energy, force and charge labels of each size group's clusters from
    the teacher calculator (one request a group)."""
    out = {}
    for size, mols in groups.items():
        res = teacher.eval(mols, forces=True)
        n = len(mols)
        out[size] = {
            "coord": np.stack([m["coord"] for m in mols]).astype(np.float32),
            "numbers": np.stack([m["numbers"] for m in mols]).astype(np.int64),
            "charge": np.zeros(n, np.float32),
            "energy": np.asarray(res["energy"], np.float32),
            "forces": np.asarray(res["forces"], np.float32).reshape(n, size, 3),
            "charges": np.asarray(res["charges"], np.float32).reshape(n, size),
        }
    return out


def train_gradient(params, cfg, system, labels, precision: str):
    """The loss and every trainable leaf's gradient of one force-loss step
    (``make_train_step``'s own computation) at ``precision``."""
    import torch

    from aimnetcentral_tpu_torch.calculators.calculator import ambient_matmul_context
    from aimnetcentral_tpu_torch.train import step as tstep
    from aimnetcentral_tpu_torch.train.loss import LossConfig, MTLoss

    state = tstep.init_train_state(params, tstep.make_optimizer())
    leaves = [leaf for _p, leaf in state.trainable]
    with ambient_matmul_context(tstep.ambient_for(precision)):
        pred = tstep.predict(state.params, cfg, system, True, create_graph=True)
        total, _ = MTLoss(LossConfig())(pred, labels, system)
        grads = torch.autograd.grad(total, leaves, allow_unused=True)
    return float(total.detach()), {p: (torch.zeros_like(x) if g is None else g).detach().double().cpu()
                                   for (p, x), g in zip(state.trainable, grads)}


def leaf_errors(got: dict, ref: dict) -> dict:
    """Each leaf's largest |got - ref| over its largest |ref|."""
    return {p: float((got[p] - ref[p]).abs().max() / max(float(ref[p].abs().max()), 1e-30)) for p in ref}


def train_constants_kernel(label: str, system, cfg, params) -> dict:
    """Kernel B's constants' build against its plain version on the
    molecule bins of a train batch (``system``), at both conv widths, in
    f32, against a plain run in f64 (no farther than twice the f32 plain),
    and its pairs against the plain count; times and bound."""
    import torch

    from aimnetcentral_tpu_torch.kernels import conv_stencil as cs
    from aimnetcentral_tpu_torch.kernels.conv_pass import build_conv_tables
    from aimnetcentral_tpu_torch.ops.binned import stencil_radius

    dev = torch.device("cuda")
    grid = system.bins
    tab = build_conv_tables(grid, stencil_radius(cfg.aev.rc_s, grid))
    b, c, g = grid.total_bins, grid.capacity, cfg.nshifts
    s_tot = tab["nbr"].shape[0]
    aev = params["aev"]
    base = dict(
        coord=system.coord.reshape(b, c, 3).contiguous(),
        mask=(system.numbers > 0).float().reshape(b, c).contiguous(),
        shift=torch.as_tensor(tab["push"], device=dev).contiguous(),
        nbr=torch.as_tensor(tab["nbr"], device=dev),
        shifts_g=aev["shifts_s"].detach().contiguous(),
        scal=torch.stack([aev["eta_s"], aev["rc_s"]]).detach().contiguous(),
    )
    mnbr = torch.as_tensor(tab["mnbr"], device=dev)
    gen = torch.Generator(device=dev).manual_seed(2)
    names = ("grad_a", "grad_coord", "grad_shift", "grad_shifts_g", "grad_scal")
    res = {"grid": {"b": b, "c": c, "s": s_tot}}
    for f in (cfg.nfeature, cfg.nfeature + cfg.num_charge_channels):
        st = cs.ConvStatic(b_tot=b, c=c, g=g, f=f, s_tot=s_tot)
        ops = dict(base, a_gmajor=0.3 * torch.randn((b, c, g * f), generator=gen, device=dev))
        gbar = torch.randn((b, 4, c, g * f), generator=gen, device=dev)
        plain_rows = cs.pair_counts_plain(st, ops["coord"], ops["mask"], ops["shift"], ops["nbr"], ops["scal"])
        n_pairs = int(plain_rows.sum())
        counts = torch.zeros(b * c, dtype=torch.int32, device=dev)
        before = cs.conv_stencil_backward_constants.launches
        got = cs.conv_stencil_backward_constants(st, **ops, mnbr=mnbr, gbar=gbar, pair_counts=counts)
        torch.cuda.synchronize()
        if not torch.equal(counts.long(), plain_rows):
            raise SystemExit(f"FAIL: B's constants' build contracted other pairs than the plain count on {label}")
        ref = cs.conv_backward_plain(st, **ops, gbar=gbar, constants=True)
        errs = {n: (float((x - y).abs().max()), float(y.abs().max())) for n, x, y in zip(names, got, ref)}
        for n, (e, s) in errs.items():
            if e > REL_TOL * s:
                raise SystemExit(f"FAIL: B's constants' build {n} disagrees with its plain version at F={f} on {label}")
        again = cs.conv_stencil_backward_constants(st, **ops, mnbr=mnbr, gbar=gbar)
        if not all(torch.equal(x, y) for x, y in zip(got, again)):
            raise SystemExit(f"FAIL: B's constants' build does not repeat bit for bit on {label}")
        first3 = cs.conv_stencil_backward(st, **ops, mnbr=mnbr, gbar=gbar)
        for n, x, y in zip(names, got, first3):
            if float((x - y).abs().max()) > REL_TOL * float(y.abs().max()):
                raise SystemExit(f"FAIL: B's two builds disagree on {n} on {label}")
        ops64 = {k: (v.double() if v.is_floating_point() else v) for k, v in ops.items()}
        ref64 = cs.conv_backward_plain(st, **ops64, gbar=gbar.double(), constants=True)
        f64 = {n: (rel64(x, z), rel64(y, z)) for n, x, y, z in zip(names, got, ref, ref64)}
        log(f"[train kernels {label}] F={f}: B constants' build against its plain version: "
            + "; ".join(f"{n} {e:.2e} (of {s:.2e})" for n, (e, s) in errs.items())
            + "; against f64: " + "; ".join(f"{n} kernel {a:.2e}, plain {p:.2e}" for n, (a, p) in f64.items()))
        for n, (a, p) in f64.items():
            if a > max(2.0 * p, F64_FLOOR):
                raise SystemExit(f"FAIL: B's constants' build {n} is farther from f64 than twice the f32 plain on "
                                 f"{label}")
        ms = time_cuda(lambda: cs.conv_stencil_backward_constants(st, **ops, mnbr=mnbr, gbar=gbar), reps=10)
        ms_b = time_cuda(lambda: cs.conv_stencil_backward(st, **ops, mnbr=mnbr, gbar=gbar), reps=10)
        plain = time_cuda(lambda: cs.conv_backward_plain(st, **ops, gbar=gbar, constants=True), reps=3, warmup=1)
        cs.conv_stencil_backward_constants.launches = before  # the checks' launches are not the main path's
        feat = 4 * b * c * g * f
        small = 4 * (b * c * 4 + 2 * s_tot * b * 3 + s_tot * b)
        nbytes = feat + 4 * feat + feat + small + 4 * (b * c * 3 + s_tot * b * 3) + 4 * (g + 2)
        # B's two contractions (2 x 2 x 4 G F a pair) and the constants' 10 a column a pair
        flops = (16.0 + 10.0) * g * f * n_pairs
        bnd, by = bound(nbytes, flops)
        log(f"[train kernels {label}] F={f} (G*F = {g * f}): B constants' build {ms:.3f} ms, the build without "
            f"{ms_b:.3f} ms, plain {plain:.3f} ms, bound {bnd:.4f} ms by {by}; {n_pairs} real ordered pairs; "
            f"{b} x {cs.bwd_tiles(st)} blocks, {cs.bwd_smem_bytes(st, True)} B shared memory")
        res[f"F{f}"] = {"ms": ms, "ms_without": ms_b, "plain_ms": plain, "bound_ms": bnd, "bound_by": by,
                        "pairs": n_pairs, "errors": errs, "f64": f64,
                        "max_abs_err": max(e for e, _s in errs.values())}
        del ops, ops64, gbar, got, ref, ref64, again, first3
        torch.cuda.empty_cache()
    return res


def train_profile(step, state, system, labels) -> dict:
    """One profiled step: device time by part (A, B's two builds, D, E, the
    plain second-order VJPs inside ConvAccBwd / PairAccBwd's backward, the
    GEMMs elsewhere, the rest)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from aimnetcentral_tpu_torch.kernels import conv_pass as cp
    from aimnetcentral_tpu_torch.kernels import pair_sweep as ps

    saved = (cp.ConvAccBwd.backward, ps.PairAccBwd.backward)

    def spanned(fn):
        def backward(ctx, *grads):
            with record_function("plain_second_order"):
                return fn(ctx, *grads)
        return staticmethod(backward)

    cp.ConvAccBwd.backward = spanned(saved[0])
    ps.PairAccBwd.backward = spanned(saved[1])
    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            step(state, system, labels)
            torch.cuda.synchronize()
    finally:
        cp.ConvAccBwd.backward, ps.PairAccBwd.backward = saved

    # kernels launched by the torch ops inside the spans (each CPU event
    # carries the kernels it launched); the kernels by name on the device
    # timeline
    events = prof.events()

    def subtree_kernels(e, out):
        out.extend(getattr(e, "kernels", []) or [])
        for ch in e.cpu_children:
            subtree_kernels(ch, out)
        return out

    def kind(name: str) -> str:
        if "conv_fwd_kernel" in name:
            return "A"
        if "conv_bwd_kernel" in name:
            return "B constants" if "true>" in name else "B"
        if "pair_kernel<" in name:  # pair_kernel<Term, kAdjoint, M>
            return "E" if ", true," in name else "D"
        if any(w in name.lower() for w in ("gemm", "nvjet", "xmma", "cutlass", "sm90_", "ampere_")):
            return "GEMMs"
        return "other"

    inside = [k for e in events if e.name == "plain_second_order" for k in subtree_kernels(e, [])]
    parts = {"A": 0.0, "B": 0.0, "B constants": 0.0, "D": 0.0, "E": 0.0, "plain second-order VJPs": 0.0,
             "GEMMs": 0.0, "other": 0.0}
    for e in events:
        if on_device(e) and e.name != "plain_second_order":  # the span's own device-side annotation
            parts[kind(e.name)] += (e.time_range.end - e.time_range.start) / 1e3
    others: dict[str, float] = {}
    for e in events:
        if on_device(e) and e.name != "plain_second_order" and kind(e.name) == "other":
            others[e.name[:60]] = others.get(e.name[:60], 0.0) + (e.time_range.end - e.time_range.start) / 1e3
    plain = {"GEMMs": 0.0, "other": 0.0}
    for k in inside:
        plain["GEMMs" if kind(k.name) == "GEMMs" else "other"] += float(k.duration) / 1e3
    parts["plain second-order VJPs"] = plain["GEMMs"] + plain["other"]
    parts["GEMMs"] -= plain["GEMMs"]
    parts["other"] -= plain["other"]
    total = sum(parts.values())
    top = sorted(others.items(), key=lambda kv: -kv[1])[:6]
    return {"parts_ms": parts, "device_ms": total, "plain_gemm_ms": plain["GEMMs"], "other_top": top}


def phase_train(smi: str) -> dict:
    """Training on the card at full width (``phase_train``): the flagship
    configuration's force-loss train step on molecule bins, on 256
    gas-phase clusters (``gas_cluster``) in four size groups of 16, 24, 32
    and 48 atoms, labelled by a second random-weight model (seed 1) through
    the port's calculator, 64 more for validation.  Gates: (a) one step on
    an 8-molecule batch, card against the port's CPU run at ``exact``: the
    loss within 1e-5 relative, every leaf's gradient within a limit set from
    the CPU f32 step's own error against an f64 run (TRAIN_NOISE_FACTOR
    times it, or times the median leaf's where that is larger), which the
    ``fast`` step (the control) must exceed; (b) kernel B's constants' build against its plain
    version at a 64-molecule batch's shapes, in f32 and against f64, with
    the pair count; (c) launches per step and per validation batch
    (``TRAIN_PER_STEP``, ``TRAIN_PER_VAL``), none of the constants' build
    before this phase; (d) two steps from one state identical bit for bit;
    (e) ``Trainer.fit`` for two epochs with a checkpoint after the first, a
    resume whose second epoch equals the uninterrupted run's bit for bit,
    and ``train_loss`` falling; (f) the ``calc-sae``, ``train`` (one epoch
    on an npz-directory dataset) and ``export`` bodies of the CLI, the
    artifact on the card within ``CHECK_ABS`` of the in-memory parameters.
    Times: ms a step at 64 molecules (median of TRAIN_TIMED) at ``fast``
    and ``exact``, molecules/s, peak memory, the idle share and the device
    time by part of one profiled step."""
    import copy

    import torch
    import yaml

    from aimnetcentral_tpu_torch import cli as tcli
    from aimnetcentral_tpu_torch.calculators import AIMNet2Calculator
    from aimnetcentral_tpu_torch.data.sgdataset import SizeGroupedDataset
    from aimnetcentral_tpu_torch.kernels import conv_stencil as cs
    from aimnetcentral_tpu_torch.models import aimnet2_init
    from aimnetcentral_tpu_torch.models.bridge import params_to
    from aimnetcentral_tpu_torch.train import step as tstep
    from aimnetcentral_tpu_torch.train.export import config_to_yaml
    from aimnetcentral_tpu_torch.train.loss import LossConfig, MTLoss
    from aimnetcentral_tpu_torch.train.trainer import Trainer, TrainerConfig, save_checkpoint

    t_phase = time.perf_counter()
    res: dict = {}
    dev, cpu = torch.device("cuda"), torch.device("cpu")
    if cs.conv_stencil_backward_constants.launches != 0:
        raise SystemExit(f"FAIL: kernel B's constants' build launched {cs.conv_stencil_backward_constants.launches} "
                         f"times before the train phase (inference never asks for it)")
    log(f"[train] no phase before this one launched B's constants' build")
    cfg = flagship_config()
    params = aimnet2_init(cfg, seed=0, device="cuda")

    # the data: clusters labelled by a second random-weight model
    t0 = time.perf_counter()
    teacher = AIMNet2Calculator((aimnet2_init(cfg, seed=1, device="cuda"), cfg), device="cuda", binned_threshold=16)
    train_groups = label_groups(teacher, {n: train_clusters(n, TRAIN_PER_SIZE, 10_000 + 100 * n)
                                          for n in TRAIN_SIZES})
    val_groups = label_groups(teacher, {n: train_clusters(n, TRAIN_VAL_PER_SIZE, 20_000 + 100 * n)
                                        for n in TRAIN_SIZES})
    if teacher._prep_cache["kind"] != "packed":
        raise SystemExit("FAIL: the teacher's requests did not run on molecule bins")
    del teacher
    train_ds, val_ds = SizeGroupedDataset(train_groups), SizeGroupedDataset(val_groups)
    res["data_s"] = time.perf_counter() - t0
    log(f"[train] data: {len(train_ds)} training clusters in groups {train_ds.keys()}, {len(val_ds)} validation; "
        f"labelled by the seed-1 model on molecule bins in {res['data_s']:.1f} s")
    loss = MTLoss(LossConfig())

    # (a) one step on 8 molecules: card against CPU
    sample = train_ds[TRAIN_CHECK_SIZE].sample(np.arange(TRAIN_CHECK_MOLS))
    sys_c, lab_c = train_ds.make_batch_system_packed(TRAIN_CHECK_SIZE, sample, device=cpu)
    sys_d, lab_d = train_ds.make_batch_system_packed(TRAIN_CHECK_SIZE, sample, device=dev)
    p_cpu = params_to(params, cpu)
    t0 = time.perf_counter()
    l_cpu, g_cpu = train_gradient(p_cpu, cfg, sys_c, lab_c, "exact")
    t_cpu = time.perf_counter() - t0
    to64 = lambda tree: tstep.tree_unflatten(tree, [x.double() for _p, x in tstep.tree_leaves(tree)])  # noqa: E731
    l_64, g_64 = train_gradient(to64(p_cpu), cfg, sys_c.replace(coord=sys_c.coord.double()),
                                {k: v.double() for k, v in lab_c.items()}, "exact")
    l_card, g_card = train_gradient(params, cfg, sys_d, lab_d, "exact")
    l_fast, g_fast = train_gradient(params, cfg, sys_d, lab_d, "fast")
    noise = leaf_errors(g_cpu, g_64)
    typical = float(np.median(list(noise.values())))
    limit = {p: TRAIN_NOISE_FACTOR * max(n, typical) for p, n in noise.items()}
    err = leaf_errors(g_card, g_cpu)
    err_fast = leaf_errors(g_fast, g_cpu)
    worst = max(err, key=lambda p: err[p] / limit[p])
    worst_fast = max(err_fast, key=lambda p: err_fast[p] / limit[p])
    dl = abs(l_card - l_cpu) / abs(l_cpu)
    log(f"[train check] {smi}: one step on {TRAIN_CHECK_MOLS} molecules of {TRAIN_CHECK_SIZE} atoms (exact): loss "
        f"card {l_card:.8g}, CPU {l_cpu:.8g} (rel {dl:.2e}, limit {REL_TOL}), f64 {l_64:.8g}; the CPU f32 "
        f"gradient's own error against f64, by leaf: median {np.median(list(noise.values())):.2e}, largest "
        f"{max(noise.values()):.2e}; card against CPU: worst leaf {worst} {err[worst]:.2e} (limit "
        f"{limit[worst]:.2e}), largest {max(err.values()):.2e}; the fast control: worst {worst_fast} "
        f"{err_fast[worst_fast]:.2e} (limit {limit[worst_fast]:.2e}), loss rel {abs(l_fast - l_cpu) / abs(l_cpu):.2e}; "
        f"the CPU step {t_cpu:.2f} s")
    if dl > REL_TOL or any(err[p] > limit[p] for p in err):
        raise SystemExit("FAIL: the card's train step disagrees with the CPU's at the exact tier")
    if not any(err_fast[p] > limit[p] for p in err_fast):
        raise SystemExit("FAIL: the fast control does not exceed the exact gate: the gate cannot tell the tiers apart")
    res["check"] = {"loss_rel": dl, "noise": noise, "err": err, "err_fast": err_fast, "limit": limit,
                    "cpu_s": t_cpu}
    del p_cpu, g_cpu, g_64, g_card, g_fast

    # (b) kernel B's constants' build at a 64-molecule batch of 48 atoms
    big = train_ds[48].sample(np.arange(TRAIN_BATCH))
    sys_big, _lab = train_ds.make_batch_system_packed(48, big, device=dev)
    res["kernel"] = train_constants_kernel("packed-64x48", sys_big, cfg, params)

    # the timed steps: 64 molecules of TRAIN_TIMED_SIZE atoms
    timed = train_ds[TRAIN_TIMED_SIZE].sample(np.arange(TRAIN_BATCH))
    sys_t, lab_t = train_ds.make_batch_system_packed(TRAIN_TIMED_SIZE, timed, device=dev)
    res["steps"] = {}
    wrappers = train_counters()
    for precision in ("fast", "exact"):
        opt = tstep.make_optimizer()
        state = tstep.init_train_state(params, opt)
        step = tstep.make_train_step(cfg, loss, opt, precision=precision)
        step(state, sys_t, lab_t)  # the first step: allocator and cuBLAS set-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        for fn in wrappers.values():
            fn.launches = 0
        times = []
        for _ in range(TRAIN_TIMED):
            t0 = time.perf_counter()
            _s, metrics = step(state, sys_t, lab_t)
            float(metrics["loss"])  # the Trainer reads the loss each step
            times.append(time.perf_counter() - t0)
        launches = read_counts(wrappers)
        for name, n in launches.items():
            if n != TRAIN_PER_STEP[name] * TRAIN_TIMED:
                raise SystemExit(f"FAIL: {name} launched {n} times over {TRAIN_TIMED} train steps, expected "
                                 f"{TRAIN_PER_STEP[name]} a step")
        med = float(np.median(times))
        peak = torch.cuda.max_memory_allocated()
        prof = train_profile(step, state, sys_t, lab_t)
        idle = max(0.0, 1.0 - prof["device_ms"] / (med * 1e3))
        log(f"[train step {precision}] {smi}: 64 molecules of {TRAIN_TIMED_SIZE} atoms (C = "
            f"{sys_t.bins.capacity}): median {med * 1e3:.2f} ms a step over {TRAIN_TIMED} (min "
            f"{min(times) * 1e3:.2f}, max {max(times) * 1e3:.2f}), {TRAIN_BATCH / med:.0f} molecules/s; peak "
            f"{peak / 2**30:.3f} GiB ({(peak - held) / 2**30:.3f} above the held {held / 2**30:.3f}); launches a step "
            f"{ {k: v // TRAIN_TIMED for k, v in launches.items()} }; profiled step: device {prof['device_ms']:.2f} ms, "
            f"idle share {idle:.3f}; by part: "
            + ", ".join(f"{k} {v:.2f}" for k, v in prof["parts_ms"].items())
            + f" ms (GEMMs inside the plain VJPs {prof['plain_gemm_ms']:.2f} ms); the largest of the rest: "
            + ", ".join(f"{n} {v:.2f}" for n, v in prof["other_top"]))
        res["steps"][precision] = {"median_s": med, "times_s": times, "molecules_per_s": TRAIN_BATCH / med,
                                   "peak_bytes": peak, "held_bytes": held, "idle_share": idle, "profile": prof,
                                   "launches_per_step": {k: v // TRAIN_TIMED for k, v in launches.items()}}
        del state, step
        torch.cuda.empty_cache()

    # (d) two steps from one state, bit for bit
    opt = tstep.make_optimizer()
    step = tstep.make_train_step(cfg, loss, opt, precision="fast")
    state = tstep.init_train_state(params, opt)
    step(state, sys_t, lab_t)
    twins = [copy.deepcopy(state) for _ in range(2)]
    outs = [step(s, sys_t, lab_t) for s in twins]
    same = all(torch.equal(a, b) for (_p, a), (_q, b) in zip(tstep.tree_leaves(outs[0][0].params),
                                                            tstep.tree_leaves(outs[1][0].params)))
    same &= all(torch.equal(outs[0][1][k], outs[1][1][k]) for k in outs[0][1])
    if not same:
        raise SystemExit("FAIL: two train steps from one state differ")
    log("[train repeat] two steps from one state (the second of a run) give the same parameters and metrics bit "
        "for bit")
    del twins, outs, state

    # (e) the main path: Trainer.fit, two epochs, a checkpoint after the
    # first; a resumed trainer's second epoch against the uninterrupted one
    with tempfile.TemporaryDirectory() as work:
        ckpt = os.path.join(work, "epoch0.npz")
        tcfg = TrainerConfig(max_epochs=2, batch_size=TRAIN_BATCH, checkpoint_dir=os.path.join(work, "ck"))
        trainer = Trainer(cfg, params, train_ds, val_ds, tcfg=tcfg, device="cuda")
        first_epoch = trainer.train_epoch

        def train_epoch(epoch):
            if epoch == 1:
                save_checkpoint(ckpt, trainer.state, scheduler=trainer._checkpoint_scheduler())
            return first_epoch(epoch)

        trainer.train_epoch = train_epoch
        wrappers = train_counters()
        for fn in wrappers.values():
            fn.launches = 0
        t0 = time.perf_counter()
        fit = trainer.fit()
        torch.cuda.synchronize()
        t_fit = time.perf_counter() - t0
        launches = read_counts(wrappers)
        hist = fit["history"]
        n_steps = 2 * sum(-(-len(g) // TRAIN_BATCH) for g in train_ds.groups)
        n_val = 2 * sum(-(-len(g) // TRAIN_BATCH) for g in val_ds.groups)
        for name, n in launches.items():
            want = TRAIN_PER_STEP[name] * n_steps + TRAIN_PER_VAL[name] * n_val
            if n != want:
                raise SystemExit(f"FAIL: {name} launched {n} times in Trainer.fit, expected {want} ({n_steps} steps, "
                                 f"{n_val} validation batches)")
        log(f"[train fit] {smi}: two epochs ({n_steps} steps of {TRAIN_BATCH} molecules, {n_val} validation "
            f"batches) in {t_fit:.2f} s; launches {launches}; history: "
            + "; ".join(f"epoch {r['epoch']}: train_loss {r['train_loss']:.6g}, val_loss {r['val_loss']:.6g}, "
                        f"energy_mae {r['energy_mae']:.4g}, forces_mae {r['forces_mae']:.4g}, "
                        f"charges_mae {r['charges_mae']:.4g}" for r in hist))
        if not hist[1]["train_loss"] < hist[0]["train_loss"]:
            raise SystemExit("FAIL: train_loss did not fall over the two epochs")
        resumed = Trainer(cfg, aimnet2_init(cfg, seed=5, device="cuda"), train_ds, val_ds, tcfg=tcfg, device="cuda")
        resumed.resume(ckpt)
        again = {**resumed.train_epoch(1), **resumed.validate()}
        diff = [k for k in again if again[k] != hist[1][k]]
        same_params = all(torch.equal(a, b) for (_p, a), (_q, b) in zip(tstep.tree_leaves(resumed.state.params),
                                                                       tstep.tree_leaves(trainer.state.params)))
        if diff or not same_params:
            raise SystemExit(f"FAIL: the resumed second epoch differs from the uninterrupted one ({diff})")
        log("[train fit] resumed from the checkpoint after the first epoch, the second epoch's record and the "
            "parameters equal the uninterrupted run's bit for bit")
        res["fit"] = {"history": hist, "seconds": t_fit, "launches": launches, "steps": n_steps,
                      "val_batches": n_val}
        res["launches"] = launches
        del trainer, resumed

        # (f) the CLI's bodies: calc-sae, train (one epoch), export
        ddir = os.path.join(work, "data")
        os.makedirs(ddir)
        for size, g in train_groups.items():
            np.savez(os.path.join(ddir, f"{size:03d}.npz"), **g)
        t0 = time.perf_counter()
        sae_path = os.path.join(work, "sae.yaml")
        msg_sae = tcli.run_calc_sae(ddir, sae_path)
        model_yaml = os.path.join(work, "model.yaml")
        with open(model_yaml, "w") as f:
            yaml.safe_dump(config_to_yaml(cfg), f, sort_keys=False)  # the heads in their order
        config = {"model": config_to_yaml(cfg), "seed": 0, "data": {"train": ddir, "sae": True},
                  "trainer": {"max_epochs": 1, "batch_size": TRAIN_BATCH,
                              "checkpoint_dir": os.path.join(work, "cli-ck")}}
        config_path = os.path.join(work, "train.yaml")
        with open(config_path, "w") as f:
            yaml.safe_dump(config, f, sort_keys=False)
        lines = tcli.run_train((config_path,), device="cuda")
        ck = os.path.join(work, "cli-ck", "best.npz")
        art, art_sae = os.path.join(work, "trained.pt"), os.path.join(work, "trained-sae.pt")
        msg_export = tcli.run_export(ck, model_yaml, art)
        tcli.run_export(ck, model_yaml, art_sae, sae_path=sae_path)
        t_cli = time.perf_counter() - t0
        from aimnetcentral_tpu_torch.train.trainer import load_checkpoint_params

        trained = load_checkpoint_params(ck, params)
        mols = train_clusters(40, 4, 30_000)
        # a calculator takes the atomic shift as a float64 host table beside
        # the parameters, as the loader hands an artifact's over
        shift64 = trained["outputs"]["atomic_shift"]["weight"].double().cpu().numpy()
        direct = AIMNet2Calculator((trained, cfg, {"sae": {"atomic_shift": shift64}}), device="cuda").eval(
            mols, forces=True)
        loaded = AIMNet2Calculator(art, device="cuda").eval(mols, forces=True)
        with_sae = AIMNet2Calculator(art_sae, device="cuda").eval(mols, forces=True)
        with open(sae_path) as f:
            sae = {int(k): float(v) for k, v in yaml.safe_load(f).items()}
        shift = np.array([sum(sae[int(z)] for z in m["numbers"]) for m in mols])
        diffs = {"energy": float(np.abs(loaded["energy"] - direct["energy"]).max()),
                 "forces": float(np.abs(loaded["forces"] - direct["forces"]).max()),
                 "energy with SAE": float(np.abs(with_sae["energy"] - shift - direct["energy"]).max())}
        log(f"[train cli] {msg_sae}; train: {lines}; {msg_export}; {t_cli:.1f} s; the artifact on the card against "
            f"the checkpoint's parameters in memory (4 clusters of 40 atoms): |dE| {diffs['energy']:.3e} eV, "
            f"|dF| {diffs['forces']:.3e} eV/A, with the SAE artifact less the SAE sum |dE| "
            f"{diffs['energy with SAE']:.3e} eV (limits {CHECK_ABS['energy']}, {CHECK_ABS['forces']})")
        if (diffs["energy"] > CHECK_ABS["energy"] or diffs["forces"] > CHECK_ABS["forces"]
                or diffs["energy with SAE"] > CHECK_ABS["energy"]):
            raise SystemExit("FAIL: the exported artifact disagrees with the in-memory parameters")
        if json.loads(lines[0])["epochs"] != 1:
            raise SystemExit("FAIL: the train command did not run its one epoch")
        res["cli"] = {"seconds": t_cli, "diffs": diffs, "train": lines}

    k = res["kernel"][f"F{cfg.nfeature + cfg.num_charge_channels}"]
    res["row"] = {"name": "conv_stencil_backward_constants", "route": "cuda",
                  "source": "aimnetcentral_tpu_torch/csrc/conv_bwd.cu",
                  "replaces": "aimnetcentral_tpu/kernels/conv_stencil.py:466",
                  "launches": res["launches"]["conv_stencil_backward_constants"],
                  "ms": k["ms"], "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
                  "max_abs_err": k["max_abs_err"], "library_ms": None,
                  "launches_per_train_step": TRAIN_PER_STEP["conv_stencil_backward_constants"]}
    res["seconds"] = time.perf_counter() - t_phase
    log(f"[train] phase done in {res['seconds']:.1f} s")
    return res


SPATIAL_WORLD = 4  # ranks of the spatial phase's world: a ring of two uses the first two, the 2 x 2 torus all four
SPATIAL_TIMED = 3  # timed spatial requests a configuration, after one that uploads the tables
SPATIAL_MD_STEPS = 20  # NVE steps of SpatialMDDriver on the 10k ring
SPATIAL_MD_CHUNK = 10  # steps between its global re-bins
SPATIAL_E_TOL = (2e-6, 2e-5)  # energy rtol, atol (the JAX package's tests/test_spatial.py)
SPATIAL_F_TOL = (3e-5, 3e-6)  # forces: of the largest |F|, plus absolute (the same tests)


def plain_spies() -> dict:
    """Count the calls of the kernels' plain versions that get CUDA tensors
    (the port takes a plain version only for CPU tensors); returns the
    counts, which the wrapped functions fill."""
    import torch

    from aimnetcentral_tpu_torch.kernels import conv_pass as cp
    from aimnetcentral_tpu_torch.kernels import conv_stencil as cs
    from aimnetcentral_tpu_torch.kernels import pair_sweep as ps

    counts: dict = {}

    def spy(name, fn):
        def wrapped(*args, **kw):
            if any(isinstance(a, torch.Tensor) and a.is_cuda for a in (*args, *kw.values())):
                counts[name] = counts.get(name, 0) + 1
            return fn(*args, **kw)
        return wrapped

    for mod, name in ((cs, "conv_forward_plain"), (cs, "conv_backward_plain"), (cp, "conv_backward_plain"),
                      (ps, "pair_forward_plain"), (ps, "pair_backward_plain")):
        setattr(mod, name, spy(name, getattr(mod, name)))
    return counts


def spatial_request(job: dict, device, wrappers: dict, plain: dict) -> dict:
    """One rank's share of a spatial configuration: a request that uploads
    the tables, ``SPATIAL_TIMED`` timed requests (energy and the assembled
    forces at the exact tier; the kernels' launches and the plain calls
    counted over them, the rank's peak memory), a bitwise repeat, and one
    more request with the collectives timed."""
    import torch

    from aimnetcentral_tpu_torch.calculators.calculator import ambient_matmul_context
    from aimnetcentral_tpu_torch.models.bridge import params_to
    from aimnetcentral_tpu_torch.parallel import collectives as co
    from aimnetcentral_tpu_torch.parallel.mesh import make_spatial_mesh
    from aimnetcentral_tpu_torch.parallel.spatial import make_spatial_energy_fn, plan_spatial, spatial_forces

    n_sp, n_spy = job["mesh"]
    spec = plan_spatial(job["system"], job["cfg"], n_sp, n_spy)
    mesh = make_spatial_mesh(n_sp, n_spy, device)
    if mesh is None:
        return {}
    system = job["system"].to(device)
    params = params_to(job["params"], device)
    efn = make_spatial_energy_fn(job["cfg"], spec, mesh, ewald_kpts=system.ewald_kpts)
    args = (params, system.coord, system.numbers, system.charge, system.cell[0], system.mult)
    with ambient_matmul_context("highest"):
        first = spatial_forces(efn, *args)
        torch.cuda.synchronize()
        reset_counts()
        plain.clear()
        torch.cuda.reset_peak_memory_stats(device)
        times = []
        for _ in range(SPATIAL_TIMED):
            t0 = time.perf_counter()
            out = spatial_forces(efn, *args)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        launches = read_counts(wrappers)
        peak = torch.cuda.max_memory_allocated(device)
        repeat = bool(torch.equal(first["forces"], out["forces"]) and torch.equal(first["energy"], out["energy"]))
        co.clock.reset()
        co.clock.on = True
        spatial_forces(efn, *args)
        co.clock.on = False
    return {
        "energy": float(out["energy"][0]), "forces": out["forces"].cpu().numpy() if mesh.lead else None,
        "request_ms": sorted(times)[len(times) // 2] * 1e3, "launches_per_request": {
            k: v / SPATIAL_TIMED for k, v in launches.items()}, "plain_calls": dict(plain), "peak_bytes": peak,
        "repeat_bitwise": repeat, "exchange_ms": 1e3 * co.clock.exchange,
        "all_reduce_ms": 1e3 * co.clock.all_reduce, "coords": mesh.coords,
        "halo": spec.halo, "ext_nbins": spec.ext_grid.nbins,
    }


def spatial_md(job: dict, device, wrappers: dict, plain: dict) -> dict:
    """One rank's share of ``SPATIAL_MD_STEPS`` NVE steps of SpatialMDDriver
    at the exact tier: the epot trace, the initial state and the end
    velocities (global slot order), ms a step, launches."""
    import torch

    from aimnetcentral_tpu_torch.dynamics import MDConfig
    from aimnetcentral_tpu_torch.models.bridge import params_to
    from aimnetcentral_tpu_torch.parallel.spatial import SpatialMDDriver

    n_sp, n_spy = job["mesh"]
    params = params_to(job["params"], device)
    md = MDConfig(dt_fs=0.5, temperature_K=300.0, thermostat="nve", precision="exact")
    drv = SpatialMDDriver(params, job["cfg"], job["system"], md, n_sp, seed=0, n_spy=n_spy, device=device)
    veloc0, masses0 = drv.gather(drv.veloc), drv.gather(drv.masses)
    reset_counts()
    plain.clear()
    drv.run(0)  # the initial forces
    epot0 = float(drv.epot[0])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = drv.run(SPATIAL_MD_STEPS, chunk=SPATIAL_MD_CHUNK)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / SPATIAL_MD_STEPS
    lead = drv.mesh.lead
    veloc1, masses1 = drv.gather(drv.veloc), drv.gather(drv.masses)
    return {
        "epot0": epot0, "epot": out["epot"], "step_ms": step_ms, "launches": read_counts(wrappers),
        "plain_calls": dict(plain),
        **({"veloc0": veloc0.cpu().numpy(), "masses0": masses0.cpu().numpy(), "veloc1": veloc1.cpu().numpy(),
            "masses1": masses1.cpu().numpy()} if lead else {}),
    }


def spatial_rank(rank: int, device, jobs: list, out_dir: str) -> None:
    """The body of one rank of the spatial phase's world (spawned: it
    imports this file, and loads the kernels the parent built).  Every rank
    takes part in every job's group creation; ranks beyond a job's mesh
    then wait for the next."""
    import pickle

    import torch.distributed as dist

    from aimnetcentral_tpu_torch.parallel.mesh import make_spatial_mesh

    wrappers, plain = counters(), plain_spies()
    res = {"backend": dist.get_backend(), "world": dist.get_world_size(), "device": str(device)}
    for job in jobs:
        n_sp, n_spy = job["mesh"]
        if rank >= n_sp * n_spy:
            make_spatial_mesh(n_sp, n_spy, device)
            continue
        run = spatial_md if job["kind"] == "md" else spatial_request
        res[job["name"]] = run(job, device, wrappers, plain)
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as fh:
        pickle.dump(res, fh)


def ext_shard(spec, sysb, coords):
    """The extended grid of the rank at mesh ``coords`` built in one
    process by periodic indexing (what its halo exchanges give it): the
    layout on which that rank's kernels run."""
    import torch

    from aimnetcentral_tpu_torch.ops.math import cellmul

    nx, ny, _nz = spec.grid.nbins
    dev = sysb.coord.device
    xi = (torch.arange(spec.nx_ext, device=dev) + coords[0] * spec.nx_local - spec.halo) % nx
    y0 = coords[1] * spec.ny_local - spec.hy if spec.n_spy > 1 else 0
    yi = (torch.arange(spec.ny_ext, device=dev) + y0) % ny

    def ext(x):
        t = x.reshape((nx, ny, spec.col_slots) + x.shape[1:])
        return t[xi][:, yi].reshape((-1,) + x.shape[1:])

    numbers = ext(sysb.numbers)
    return sysb.replace(
        coord=ext(sysb.coord) + cellmul(spec.halo_wraps(coords, dev), sysb.cell[0]), numbers=numbers,
        mol_idx=torch.where((numbers > 0) & spec.core_mask(dev), 0, 1), bins=spec.ext_grid,
    )


def single_reference(params, cfg, sysb, reps: int = 1) -> tuple[float, np.ndarray, float]:
    """The single-device port on the same binned system at the exact tier:
    energy, forces and the median ms of ``reps`` requests."""
    import torch

    from aimnetcentral_tpu_torch.calculators.calculator import ambient_matmul_context
    from aimnetcentral_tpu_torch.models import aimnet2_apply

    times = []
    with ambient_matmul_context("highest"):
        for _ in range(reps + 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            c = sysb.coord.detach().requires_grad_(True)
            e = aimnet2_apply(params, cfg, sysb.replace(coord=c), sae_external=True)["energy"].sum()
            (g,) = torch.autograd.grad(e, c)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
    return float(e.detach()), (-g).cpu().numpy(), sorted(times[1:])[len(times[1:]) // 2] * 1e3


def spatial_agree(label: str, got_e: float, got_f, ref_e: float, ref_f, numbers) -> dict:
    """Energy and forces against the reference within ``SPATIAL_E_TOL``
    and ``SPATIAL_F_TOL``; fails beyond them."""
    real = np.asarray(numbers) > 0
    de = abs(got_e - ref_e)
    e_lim = SPATIAL_E_TOL[0] * abs(ref_e) + SPATIAL_E_TOL[1]
    df = float(np.abs(got_f - ref_f)[real].max()) if got_f is not None else 0.0
    f_lim = SPATIAL_F_TOL[0] * float(np.abs(ref_f).max()) + SPATIAL_F_TOL[1]
    log(f"[spatial {label}] against the single-device port: E {got_e:.6f} / {ref_e:.6f} eV, |dE| {de:.3e} "
        f"(limit {e_lim:.3e}); max |dF| {df:.3e} eV/A (limit {f_lim:.3e})")
    if de > e_lim or df > f_lim:
        raise SystemExit(f"FAIL: the spatial decomposition disagrees with the single-device port on {label}")
    return {"dE": de, "dE_limit": e_lim, "dF": df, "dF_limit": f_lim}


def spatial_systems(params, cfg, params_d3, cfg_d3, coord, numbers, cell) -> dict:
    """The spatial phase's binned systems, on one grid as JAX plans it (the
    calculator's SR grid of the 10k box, its LR twin dropped), with their
    calculators: flagship-10k, ewald-d3-10k and pme-d3-10k (wb97m-d3 with
    Ewald or PME)."""
    from aimnetcentral_tpu_torch.calculators import AIMNet2Calculator

    data = {"coord": coord, "numbers": numbers, "cell": cell}
    one_grid = dict(lr_bins=None, lr_slot=None, lr_inv=None)
    cfg_ew, cfg_pme = ewald_config(cfg_d3), ewald_config(cfg_d3, "pme")
    calc = AIMNet2Calculator((params, cfg), device="cuda")
    calc_ew = AIMNet2Calculator((params_d3, cfg_ew), device="cuda")
    return {
        "calc": calc, "sysb": calc.prepare_system(data).replace(**one_grid),
        "calc_ew": calc_ew, "cfg_ew": cfg_ew, "sys_ew": calc_ew.prepare_system(data).replace(**one_grid),
        "cfg_pme": cfg_pme,
        "sys_pme": AIMNet2Calculator((params_d3, cfg_pme), device="cuda").prepare_system(data).replace(**one_grid),
    }


def phase_spatial_kernels(params, cfg, params_d3, cfg_d3, coord, numbers, cell) -> dict:
    """A, B, D and E against their plain versions (as phase 3) on the
    extended grids of the spatial phase's shards: a ring shard's (10 x 8 x
    8, bounded in x) and a torus shard's (10 x 10 x 8, bounded in x and y)
    for A and B, the ring shard's for D and E with DSF at S = 172, and the
    D3 energy term's K = 41 extras at S = 172 on ewald-d3's ring shard."""
    from aimnetcentral_tpu_torch.parallel.spatial import plan_spatial

    t_phase = time.perf_counter()
    sy = spatial_systems(params, cfg, params_d3, cfg_d3, coord, numbers, cell)
    calc, sysb = sy["calc"], sy["sysb"]
    res: dict = {}
    for label, spec_args in (("ring", (2, 1)), ("torus", (2, 2))):
        spec = plan_spatial(sysb, cfg, *spec_args)
        shard = ext_shard(spec, sysb, (0, 0))
        log(f"[spatial kernels] {label} shard 0: global grid {spec.grid.nbins} C={spec.grid.capacity}, halo "
            f"{spec.halo}, extended grid {spec.ext_grid.nbins} periodic axes {spec.ext_grid.axes_periodic}")
        _rows, res[f"{label} A, B"] = phase_kernels(calc, shard, f"spatial {label} shard", fs=(cfg.nfeature + 1,))
        if label == "ring":
            _rows, res["ring D, E"] = phase_pair_kernels(calc, shard, "spatial ring shard")
    spec_ew = plan_spatial(sy["sys_ew"], sy["cfg_ew"], 2, 1)
    _rows, res["ewald-d3 ring D, E"] = phase_pair_kernels(
        sy["calc_ew"], ext_shard(spec_ew, sy["sys_ew"], (0, 0)), "spatial ewald-d3 ring shard", only=("d3_energy",))
    res["seconds"] = time.perf_counter() - t_phase
    log(f"[spatial kernels] done in {res['seconds']:.1f} s")
    return res


def phase_spatial(params, cfg, params_d3, cfg_d3, coord, numbers, cell) -> dict:
    """Spatial decomposition on the card (``parallel/``): one world of
    ``SPATIAL_WORLD`` ranks spawned after the parent built the kernels
    (each rank loads the built libraries): gloo with the halo buffers
    staged through the host on one card, NCCL with a card a rank.  On
    flagship-10k at full width (DSF at 15 A under PBC, the calculator's SR
    grid, one grid as JAX plans it: a halo of three planes): a ring of two
    and the 2 x 2 torus, each rank's A, B, D, E launches and no plain call
    on the card, energy and forces against the single-device port on the
    same binned system, a bitwise repeat, request and exchange ms, each
    rank's peak; 20 NVE steps of SpatialMDDriver on the ring against the
    single-device velocity Verlet from the same state, and its NVE drift;
    wb97m-d3 with Ewald (ewald-d3-10k: the real-space cutoff's halo of four
    planes, the largest a ring of two on eight planes holds) and with PME
    on the ring, against the single-device port and PME against Ewald."""
    import pickle

    import torch

    from aimnetcentral_tpu_torch import constants
    from aimnetcentral_tpu_torch.calculators.calculator import ambient_matmul_context
    from aimnetcentral_tpu_torch.models import aimnet2_apply
    from aimnetcentral_tpu_torch.models.bridge import params_to
    from aimnetcentral_tpu_torch.models.heads import auto_switch_simple_to_dsf
    from aimnetcentral_tpu_torch.parallel.mesh import spawn

    t_phase = time.perf_counter()
    res: dict = {}
    sy = spatial_systems(params, cfg, params_d3, cfg_d3, coord, numbers, cell)
    sysb, sys_ew, sys_pme, cfg_ew, cfg_pme = sy["sysb"], sy["sys_ew"], sy["sys_pme"], sy["cfg_ew"], sy["cfg_pme"]
    cfg_dsf = auto_switch_simple_to_dsf(cfg)

    # the single-device port on the same binned systems
    ref_e, ref_f, single_ms = single_reference(params, cfg_dsf, sysb, reps=SPATIAL_TIMED)
    ew_e, ew_f, _ms = single_reference(params_d3, cfg_ew, sys_ew)
    pme_e, pme_f, _ms = single_reference(params_d3, cfg_pme, sys_pme)
    log(f"[spatial] single-device flagship-10k request (energy and forces, exact): {single_ms:.2f} ms")

    # the ranks get the references' own parameters (one pickled copy each)
    cpu = torch.device("cpu")
    p_cpu, p_d3_cpu = params_to(params, cpu), params_to(params_d3, cpu)
    flagship = {"cfg": cfg, "params": p_cpu, "system": sysb.to(cpu)}
    jobs = [
        {"name": "ring flagship-10k", "kind": "request", "mesh": (2, 1), **flagship},
        {"name": "torus flagship-10k", "kind": "request", "mesh": (2, 2), **flagship},
        {"name": "md ring flagship-10k", "kind": "md", "mesh": (2, 1), **flagship},
        {"name": "ring ewald-d3-10k", "kind": "request", "mesh": (2, 1), "cfg": cfg_ew, "params": p_d3_cpu,
         "system": sys_ew.to(cpu)},
        {"name": "ring pme-d3-10k", "kind": "request", "mesh": (2, 1), "cfg": cfg_pme, "params": p_d3_cpu,
         "system": sys_pme.to(cpu)},
    ]
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as out_dir:
        spawn(spatial_rank, SPATIAL_WORLD, args=(jobs, out_dir), device="cuda")
        ranks = []
        for r in range(SPATIAL_WORLD):
            with open(os.path.join(out_dir, f"rank{r}.pkl"), "rb") as fh:
                ranks.append(pickle.load(fh))
    res["world_s"] = time.perf_counter() - t0
    log(f"[spatial] world of {SPATIAL_WORLD} ranks: backend {ranks[0]['backend']}, world size {ranks[0]['world']}, "
        f"devices {[r['device'] for r in ranks]} ({torch.cuda.device_count()} card(s): "
        f"{'NCCL' if ranks[0]['backend'] == 'nccl' else 'gloo, buffers staged through the host'}); "
        f"{res['world_s']:.1f} s from spawn to join")
    res["backend"], res["world"] = ranks[0]["backend"], ranks[0]["world"]

    launches = {name: 0 for name in counters()}
    per_request = {"ring flagship-10k": 1, "torus flagship-10k": 1, "ring ewald-d3-10k": 3, "ring pme-d3-10k": 3}
    refs = {"ring flagship-10k": (ref_e, ref_f), "torus flagship-10k": (ref_e, ref_f),
            "ring ewald-d3-10k": (ew_e, ew_f), "ring pme-d3-10k": (pme_e, pme_f)}
    for job in jobs:
        name = job["name"]
        n_ranks = job["mesh"][0] * job["mesh"][1]
        shares = [r[name] for r in ranks[:n_ranks]]
        for r, share in enumerate(shares):
            got = share.get("launches_per_request", share.get("launches"))
            if any(v == 0 for v in got.values()) or share["plain_calls"]:
                raise SystemExit(f"FAIL: rank {r} of {name} launched {got}, plain calls on the card "
                                 f"{share['plain_calls']}")
            if job["kind"] == "request":
                want = {"conv_stencil_forward": 3, "conv_stencil_backward": 3,
                        "pair_sweep_forward": per_request[name], "pair_sweep_backward": per_request[name]}
                if got != want:
                    raise SystemExit(f"FAIL: rank {r} of {name} launched {got} a request, expected {want}")
                if not share["repeat_bitwise"]:
                    raise SystemExit(f"FAIL: rank {r} of {name}: a repeated request differs")
                for k, v in got.items():
                    launches[k] += int(v * SPATIAL_TIMED)
            else:
                for k, v in got.items():
                    launches[k] += v
        if job["kind"] == "request":
            lead = shares[0]
            res[name] = {
                "agree": spatial_agree(name, lead["energy"], lead["forces"], *refs[name], job["system"].numbers),
                "request_ms": [s["request_ms"] for s in shares], "exchange_ms": [s["exchange_ms"] for s in shares],
                "all_reduce_ms": [s["all_reduce_ms"] for s in shares],
                "peak_bytes": [s["peak_bytes"] for s in shares], "launches_per_request": lead["launches_per_request"],
                "halo": lead["halo"], "ext_nbins": lead["ext_nbins"], "energy": lead["energy"],
            }
            log(f"[spatial {name}] {n_ranks} ranks ({ranks[0]['backend']}), halo {lead['halo']} planes, extended "
                f"grid {lead['ext_nbins']}: request {', '.join(f'{s:.2f}' for s in res[name]['request_ms'])} ms by "
                f"rank (single device {single_ms:.2f} ms), halo exchanges "
                f"{', '.join(f'{s:.2f}' for s in res[name]['exchange_ms'])} ms and all-reduces "
                f"{', '.join(f'{s:.2f}' for s in res[name]['all_reduce_ms'])} ms of a timed request (synchronised), "
                f"peak {', '.join(f'{s / 2**30:.3f}' for s in res[name]['peak_bytes'])} GiB by rank; launches a "
                f"request on every rank {lead['launches_per_request']}; no plain call on the card; a repeat "
                f"bit for bit")

    # PME against Ewald on the same ring
    d_lr = abs(res["ring pme-d3-10k"]["energy"] - res["ring ewald-d3-10k"]["energy"])
    lr_lim = LR_PME_REL * max(1.0, abs(res["ring ewald-d3-10k"]["energy"]))
    log(f"[spatial] ring PME against ring Ewald: |dE| {d_lr:.3e} eV (limit {lr_lim:.3e})")
    if d_lr > lr_lim:
        raise SystemExit("FAIL: spatial PME and Ewald disagree beyond LR_PME_REL")

    # MD: the single-device velocity Verlet from SpatialMDDriver's state
    md = ranks[0]["md ring flagship-10k"]
    dt = float(np.float32(0.5) * np.float32(constants.fs))
    m = torch.as_tensor(md["masses0"], device="cuda")[:, None]
    veloc = torch.as_tensor(md["veloc0"], device="cuda")
    c = sysb.coord
    real = (sysb.numbers > 0)[:, None]
    ref_epot = []
    with ambient_matmul_context("highest"):
        def force(x):
            x = x.detach().requires_grad_(True)
            e = aimnet2_apply(params, cfg_dsf, sysb.replace(coord=x), sae_external=True)["energy"].sum()
            return -torch.autograd.grad(e, x)[0], float(e.detach())

        f, e0 = force(c)
        for _ in range(SPATIAL_MD_STEPS):
            v_half = veloc + 0.5 * dt * torch.where(real, f / m, 0.0)
            c = c + dt * v_half
            f, e = force(c)
            veloc = v_half + 0.5 * dt * torch.where(real, f / m, 0.0)
            ref_epot.append(e)
    d_md = np.abs(md["epot"] - np.array(ref_epot))
    md_lim = SPATIAL_E_TOL[0] * np.abs(ref_epot) + SPATIAL_E_TOL[1]

    def etot(epot, v, mass):
        return float(epot) + 0.5 * float((mass[:, None] * v.astype(np.float64) ** 2).sum())

    e_first, e_last = etot(md["epot0"], md["veloc0"], md["masses0"]), etot(md["epot"][-1], md["veloc1"], md["masses1"])
    drift = abs(e_last - e_first) / abs(e_first)
    res["md"] = {"step_ms": [r["md ring flagship-10k"]["step_ms"] for r in ranks[:2]],
                 "epot_max_dE": float(d_md.max()),
                 "etot_first_last_eV": (e_first, e_last), "etot_drift": drift,
                 "launches": [r["md ring flagship-10k"]["launches"] for r in ranks[:2]]}
    log(f"[spatial md ring flagship-10k] {SPATIAL_MD_STEPS} NVE steps (0.5 fs, exact, a global re-bin every "
        f"{SPATIAL_MD_CHUNK}): {res['md']['step_ms'][0]:.2f} ms a step; epot against the single-device velocity "
        f"Verlet from the same state: largest |dE| {d_md.max():.3e} eV (limit {md_lim.min():.3e} and up); total "
        f"energy {e_first:.4f} -> {e_last:.4f} eV, drift {drift:.2e} (limit {MD_NVE_DRIFT:.0e}); launches by rank "
        f"{res['md']['launches']}")
    if (d_md > md_lim).any() or drift > MD_NVE_DRIFT:
        raise SystemExit("FAIL: spatial MD disagrees with the single-device velocity Verlet or drifts")
    res["launches"] = launches
    res["seconds"] = time.perf_counter() - t_phase
    log(f"[spatial] launches in the phase's main-path runs (every rank) {launches}; phase done in "
        f"{res['seconds']:.1f} s")
    return res


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", help="write the full results as JSON to this file")
    args = parser.parse_args()
    t_run = time.perf_counter()
    smi = phase_card()
    sys.path.insert(0, ROOT)
    import torch

    from aimnetcentral_tpu_torch.calculators import AIMNet2Calculator
    from aimnetcentral_tpu_torch.dynamics import MDConfig, MDDriver
    from aimnetcentral_tpu_torch.models import aimnet2_init

    results: dict = {"card": smi}
    results["build"] = phase_build()
    from aimnetcentral_tpu_torch.kernels import conv_stencil as cs

    cs.conv_stencil_backward_constants.launches = 0  # phase train checks that no phase before it launched this

    cfg = flagship_config()
    params = aimnet2_init(cfg, seed=0, device="cuda")
    calc = AIMNet2Calculator((params, cfg), device="cuda")
    cfg_d3 = wb97m_d3_config()
    params_d3 = aimnet2_init(cfg_d3, seed=0, device="cuda")
    calc_d3 = AIMNet2Calculator((params_d3, cfg_d3), device="cuda")
    coord, numbers, cell = build_box(N_MAIN)

    data = {"coord": coord, "numbers": numbers, "cell": cell}
    kernels, results["kernels_detail"] = phase_kernels(calc, calc.prepare_system(data), "request")
    # the MD drivers' layouts (skin 0.3 A, not the calculator's 0.6): A and
    # B on the SR layout an MD step gives them; D and E again only where
    # the LR layout's shapes differ from the request's
    md_sys = MDDriver(params, cfg, md_system(coord, numbers, cell, "cuda"), MDConfig(**MD_SETTING),
                      device="cuda").state.system
    _rows, results["kernels_detail_md"] = phase_kernels(calc, md_sys, "MD")
    sys_d3 = calc_d3.prepare_system(data)
    pair_rows, results["pair_kernels_detail"] = phase_pair_kernels(calc_d3, sys_d3)
    md_sys_d3 = MDDriver(params_d3, cfg_d3, md_system(coord, numbers, cell, "cuda"), MDConfig(**MD_SETTING),
                         device="cuda").state.system
    if lr_shape(md_sys_d3) != lr_shape(sys_d3):
        _rows, results["pair_kernels_detail_md"] = phase_pair_kernels(calc_d3, md_sys_d3)
    else:
        log(f"[kernels MD] the MD drivers' LR layout has the request's shapes (grid, capacity, stencil radius "
            f"{lr_shape(sys_d3)}): the D and E check above holds for MD")
    kernels += pair_rows
    conv = {"conv_stencil_forward": 3, "conv_stencil_backward": 3}
    results["main"] = phase_main_path(
        "flagship-10k", calc, coord, numbers, cell,
        {**conv, "pair_sweep_forward": 1, "pair_sweep_backward": 1},
    )
    results["main_d3"] = phase_main_path(
        "wb97m-d3-10k", calc_d3, coord, numbers, cell,
        {**conv, "pair_sweep_forward": 3, "pair_sweep_backward": 3},
    )
    for k in kernels:
        k["launches"] = results["main"]["launches"][k["name"]] + results["main_d3"]["launches"][k["name"]]
    results["layers"] = phase_layers(calc_d3, coord, numbers, cell)
    results["check"] = phase_card_vs_cpu("flagship", params, cfg)
    results["check_d3"] = phase_card_vs_cpu("wb97m-d3", params_d3, cfg_d3)
    results["reuse"] = phase_reuse("wb97m-d3", params_d3, cfg_d3)
    results["gas"] = phase_gas(params, cfg, params_d3, cfg_d3)
    for k in kernels:
        k["launches"] += results["gas"]["launches"][k["name"]]

    peaks = {"flagship-10k": results["main"]["peak_bytes"], "wb97m-d3-10k": results["main_d3"]["peak_bytes"]}
    md_runs = phase_md(params, cfg, params_d3, cfg_d3, coord, numbers, cell, peaks)
    results["md"] = md_runs
    results["md_check"] = phase_md_card_vs_cpu("wb97m-d3", params_d3, cfg_d3)
    results["packed"] = phase_packed(params, cfg, params_d3, cfg_d3)
    results["md_gas"] = phase_md_gas(params, cfg, params_d3, cfg_d3)
    with tempfile.TemporaryDirectory() as out_dir:
        results["artifact"] = phase_artifact(params_d3, cfg_d3, coord, numbers, cell, out_dir)
        results["integrations"] = phase_integrations(calc, calc_d3, coord, numbers, cell,
                                                     os.path.join(out_dir, "artifact-wb97m-d3.pt"))
    results["second_order"] = phase_second_order(params, cfg, params_d3, cfg_d3)
    results["long_range"] = phase_long_range(params, cfg, params_d3, cfg_d3, coord, numbers, cell)
    single_per_request = {name: n // 3 for name, n in results["main"]["launches"].items()}
    results["ensemble"] = phase_ensemble(params, cfg, coord, numbers, cell, single_per_request,
                                         results["kernels_detail"])
    results["train"] = phase_train(smi)
    results["spatial_kernels"] = phase_spatial_kernels(params, cfg, params_d3, cfg_d3, coord, numbers, cell)
    results["spatial"] = phase_spatial(params, cfg, params_d3, cfg_d3, coord, numbers, cell)
    for k in kernels:
        k["launches"] += results["spatial"]["launches"][k["name"]]
        k["launches"] += results["train"]["launches"][k["name"]]
        k["launches"] += results["ensemble"]["launches"][k["name"]]
        k["launches"] += results["long_range"]["launches"][k["name"]]
        k["launches"] += results["second_order"]["launches"][k["name"]]
        k["launches"] += results["artifact"]["launches"][k["name"]]
        k["launches"] += results["integrations"]["launches"][k["name"]]
        k["launches"] += results["packed"]["launches"][k["name"]]
        k["launches"] += sum(w["launches"][k["name"]] for w in results["md_gas"]["windows"].values())
        k["launches"] += sum(w["launches"][k["name"]] for w in md_runs["windows"].values())
        k["launches_per_md_step"] = {
            label: md_runs["windows"][label]["launches_per_step"][k["name"]]
            for label in ("flagship-10k fast", "wb97m-d3-10k fast")
        }

    kernels += results["ensemble"]["rows"]
    kernels.append(results["train"]["row"])
    results["seconds"] = time.perf_counter() - t_run
    if args.out:
        with open(args.out, "w") as fh:
            json.dump({**results, "kernels": kernels}, fh, indent=1, default=str)
    log(f"[smoke] all phases in {results['seconds']:.1f} s (the kernels' build included)")
    log(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                   "count": torch.cuda.device_count()},
    }))


if __name__ == "__main__":
    main()
