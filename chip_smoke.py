#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA card and check it.

    python3 chip_smoke.py [--out results.json]

Phases (any failure exits nonzero; nothing is caught):

1. card: needs ``torch.cuda.is_available()``; prints the nvidia-smi name
   and power limit;
2. build: compiles the CUDA kernels from aimnetcentral_tpu_torch/csrc/
   (one nvcc per source, in parallel) and prints ptxas' registers, shared
   memory and spills;
3. kernels: each kernel against its plain PyTorch version on the same
   inputs at the main path's shapes (10,000-atom flagship grid, F = 16 and
   F = 17), with times (CUDA events) and the least time the card could take;
4. main path: three ``AIMNet2Calculator.eval(forces=True)`` requests on the
   10,000-atom box at the flagship's full width (random weights from a
   seed), with the kernels' launch counts read around them;
5. layers: host-clock times of binning and of the plain DSF sweep;
6. the card against the port's own CPU run (plain versions) on a
   ~1,200-atom box: energy, forces and stress.

The last lines are the kernels' JSON record and
``{"ok": true, "device": {...}}``.  ``--out`` writes the full results
(build logs, per-F kernel detail, profile) as JSON.  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
N_MAIN = 10_000
N_CHECK = 1_200
FP32_PEAK = 67e12  # H100 SXM, FP32 outside the tensor cores (FLOP/s)
HBM_RATE = 3.35e12  # H100 SXM device memory (bytes/s)
REL_TOL = 1e-5


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


def _pair_count(st, ops, rc: float) -> int:
    """Ordered real pairs within rc over the stencil: the pairs this run's
    data needs (the kernels visit all C x C slot pairs of every offset)."""
    import torch

    nbr = ops["nbr"].clamp(min=0).long()
    real = ops["mask"] > 0.5
    total = 0
    for s in range(st.s_tot):
        cj = ops["coord"][nbr[s]] + ops["shift"][s][:, None, :]
        d2 = ((cj[:, None, :, :] - ops["coord"][:, :, None, :]) ** 2).sum(-1)
        ok = real[:, :, None] & real[nbr[s]][:, None, :] & (d2 < rc * rc)
        if s == 0:
            ok &= ~torch.eye(st.c, dtype=torch.bool, device=d2.device)[None]
        total += int(ok.sum())
    return total


def phase_kernels(calc, coord, numbers, cell) -> tuple[list[dict], dict]:
    """Kernels A and B against their plain versions at the main path's shapes."""
    import torch

    from aimnetcentral_tpu_torch.kernels import conv_stencil as cs
    from aimnetcentral_tpu_torch.kernels.conv_pass import build_conv_tables
    from aimnetcentral_tpu_torch.ops.binned import stencil_radius

    dev = torch.device("cuda")
    sysb = calc.prepare_system({"coord": coord, "numbers": numbers, "cell": cell})
    grid = sysb.bins
    cfg = calc.cfg
    tab = build_conv_tables(grid, stencil_radius(cfg.aev.rc_s, grid))
    b, c, g = grid.total_bins, grid.capacity, cfg.nshifts
    params = calc.params
    base = dict(
        coord=sysb.coord.reshape(b, c, 3).contiguous(),
        mask=(sysb.numbers > 0).float().reshape(b, c).contiguous(),
        shift=(torch.as_tensor(tab["push"], device=dev)
               + torch.as_tensor(tab["wraps"], device=dev) @ sysb.cell[0]).contiguous(),
        nbr=torch.as_tensor(tab["nbr"], device=dev),
        shifts_g=params["aev"]["shifts_s"].contiguous(),
        scal=torch.stack([params["aev"]["eta_s"], params["aev"]["rc_s"]]).contiguous(),
    )
    mnbr = torch.as_tensor(tab["mnbr"], device=dev)
    s_tot = tab["nbr"].shape[0]
    log(f"[kernels] grid {grid.nbins} B={b} C={c} G={g} S={s_tot}")
    gen = torch.Generator(device=dev).manual_seed(1)
    rc = float(cfg.aev.rc_s)
    n_pairs = None
    detail = {}
    rows = {}
    for f in (cfg.nfeature, cfg.nfeature + cfg.num_charge_channels):
        st = cs.ConvStatic(b_tot=b, c=c, g=g, f=f, s_tot=s_tot)
        ops = dict(base, a_gmajor=0.3 * torch.randn((b, c, g * f), generator=gen, device=dev))
        gbar = torch.randn((b, 4, c, g * f), generator=gen, device=dev)
        if n_pairs is None:
            n_pairs = _pair_count(st, ops, rc)
            log(f"[kernels] real ordered pairs within rc: {n_pairs} "
                f"(slot pairs visited: {b * s_tot * c * c})")

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
        log(f"[kernels] F={f} A: max_abs_err {err_a:.3e} rel {err_a / scale_a:.3e}")
        for name, (e, s) in errs_b.items():
            log(f"[kernels] F={f} B {name}: max_abs_err {e:.3e} rel {e / s:.3e}")
        if err_a > REL_TOL * scale_a:
            raise SystemExit(f"FAIL: kernel A disagrees with its plain version at F={f}")
        for name, (e, s) in errs_b.items():
            if e > REL_TOL * s:
                raise SystemExit(f"FAIL: kernel B {name} disagrees with its plain version at F={f}")

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

        def bound(nbytes, flops):
            t_bytes, t_ops = nbytes / HBM_RATE * 1e3, flops / FP32_PEAK * 1e3
            return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")

        tj, ti_b = cs.bwd_tiles(st)
        ti_a = cs.fwd_tile(st)
        log(f"[kernels] F={f} A: {ti_a} receiver rows a block, {cs.fwd_smem_bytes(st, ti_a)} B "
            f"dynamic shared memory; B: {tj} x {ti_b} atom tiles, "
            f"{cs.bwd_smem_bytes(st, tj, ti_b)} B")
        bound_a, by_a = bound(bytes_a, flops_a)
        bound_b, by_b = bound(bytes_b, flops_b)
        log(f"[kernels] F={f} A: {ms_a:.3f} ms (plain {plain_a:.3f} ms), bound {bound_a:.4f} ms "
            f"by {by_a}; slot-dense work {dense_a / 1e9:.1f} GFLOP = "
            f"{dense_a / FP32_PEAK * 1e3:.3f} ms at the FP32 peak; no single PyTorch call "
            f"computes this function (library_ms null)")
        log(f"[kernels] F={f} B: {ms_b:.3f} ms (plain {plain_b:.3f} ms), bound {bound_b:.4f} ms "
            f"by {by_b}; slot-dense work {2 * dense_a / 1e9:.1f} GFLOP")
        detail[f"F{f}"] = {
            "A": {"ms": ms_a, "plain_ms": plain_a, "bound_ms": bound_a, "bound_by": by_a,
                  "max_abs_err": err_a, "rel_err": err_a / scale_a, "bytes": bytes_a,
                  "flops_needed": flops_a, "flops_slot_dense": dense_a},
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

    # the record carries the F = 17 shapes: two of every three passes
    f_main = cfg.nfeature + cfg.num_charge_channels
    row_a, row_b = rows[f_main]
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


def phase_main_path(calc, coord, numbers, cell) -> dict:
    import torch

    from aimnetcentral_tpu_torch.kernels import conv_stencil as cs

    rng = np.random.default_rng(2)
    requests = [coord] + [
        (coord + rng.normal(scale=0.05, size=coord.shape)).astype(np.float32) for _ in range(2)
    ]
    torch.cuda.reset_peak_memory_stats()
    cs.conv_stencil_forward.launches = 0
    cs.conv_stencil_backward.launches = 0
    times, energies, outputs = [], [], []
    for x in requests:
        t0 = time.perf_counter()
        out = calc.eval({"coord": x, "numbers": numbers, "cell": cell}, forces=True)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        e, f_ = out["energy"], out["forces"]
        if not (np.isfinite(e).all() and np.isfinite(f_).all()):
            raise SystemExit("FAIL: non-finite energy or forces on the main path")
        if f_.shape != (len(numbers), 3):
            raise SystemExit(f"FAIL: forces of shape {f_.shape}")
        net = float(np.abs(f_.astype(np.float64).sum(0)).max())
        total = float(np.abs(f_).sum())
        if net > 1e-5 * total:
            raise SystemExit(f"FAIL: net force {net} against sum |F| {total}")
        energies.append(float(e[0]))
        if not outputs:
            outputs.append(out)
        log(f"[main] request: E = {e[0]:.6f} eV, |sum F| = {net:.3e} eV/A, "
            f"max |F| = {np.abs(f_).max():.4f} eV/A, {times[-1] * 1e3:.1f} ms")
    launches = {
        "conv_stencil_forward": cs.conv_stencil_forward.launches,
        "conv_stencil_backward": cs.conv_stencil_backward.launches,
    }
    log(f"[main] launches over {len(requests)} requests: {launches}")
    for name, n in launches.items():
        if n != 3 * len(requests):
            raise SystemExit(f"FAIL: {name} launched {n} times, expected 3 per request")
    peak = torch.cuda.max_memory_allocated()
    med = float(np.median(times))
    log(f"[main] per-request wall time median {med * 1e3:.1f} ms "
        f"(all: {', '.join(f'{t * 1e3:.1f}' for t in times)}), peak memory {peak / 2**30:.3f} GiB")

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
            raise SystemExit(f"FAIL: a repeated request gave another {key}")
    log("[main] a repeated request gives the same energy and forces bit for bit")
    def dev_us(e) -> float:  # the attribute was renamed across torch versions
        return float(getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0.0)))

    # kernel-level events only: their op-level parents carry the same time
    events = [e for e in prof.key_averages() if str(getattr(e, "device_type", "")).endswith("CUDA")]
    dev_total = sum(dev_us(e) for e in events) / 1e3  # ms
    top = sorted(events, key=dev_us, reverse=True)[:12]
    # the profiler slows the host several times over, so the idle share is
    # taken against the unprofiled median wall time
    log(f"[main] profiled request: wall {wall * 1e3:.1f} ms, device busy {dev_total:.1f} ms; "
        f"idle share against the unprofiled median {max(0.0, 1 - dev_total / (med * 1e3)):.3f}")
    breakdown = []
    for e in top:
        ms = dev_us(e) / 1e3
        breakdown.append({"name": e.key[:90], "ms": ms, "count": e.count})
        log(f"[main]   {ms:9.3f} ms  x{e.count:<5d} {e.key[:90]}")
    return {
        "launches": launches, "times_s": times, "median_s": med, "peak_bytes": peak,
        "energies": energies, "profile": {"wall_ms": wall * 1e3, "device_ms": dev_total,
                                          "idle_share": max(0.0, 1 - dev_total / (med * 1e3)),
                                          "top": breakdown},
    }


def phase_layers(calc, coord, numbers, cell) -> dict:
    """Host-clock time of two layers of a request, each ending in a
    synchronize (median of three): binning (``prepare_system``) and the plain
    DSF Coulomb sweep on the LR grid, forward and coordinate backward."""
    import torch

    from aimnetcentral_tpu_torch.models.engine_binned import coulomb_dsf_binned
    from aimnetcentral_tpu_torch.models.heads import LRCoulombHead

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

    t_prep = timed(lambda: calc.prepare_system(data))
    sysb = calc.prepare_system(data)
    head = next(h for _n, h in calc._effective_cfg(True).outputs if isinstance(h, LRCoulombHead))
    gen = torch.Generator(device="cuda").manual_seed(3)
    q = 0.3 * torch.randn(sysb.natoms, generator=gen, device="cuda") * (sysb.numbers > 0)

    def dsf() -> None:
        c = sysb.coord.detach().requires_grad_(True)
        e = coulomb_dsf_binned(sysb.replace(coord=c), q, head.rc, head.dsf_alpha, head.dsf_rc,
                               head.envelope, head.subtract_sr)
        torch.autograd.grad(e.sum(), c)

    t_dsf = timed(dsf)
    log(f"[layers] prepare_system {t_prep * 1e3:.1f} ms; DSF sweep forward + backward "
        f"{t_dsf * 1e3:.1f} ms (medians of 3)")
    return {"prepare_s": t_prep, "dsf_fwd_bwd_s": t_dsf}


def phase_card_vs_cpu(params, cfg) -> dict:
    import torch

    from aimnetcentral_tpu_torch.calculators import AIMNet2Calculator
    from aimnetcentral_tpu_torch.models.bridge import params_to

    coord, numbers, cell = build_box(N_CHECK, seed=1)
    data = {"coord": coord, "numbers": numbers, "cell": cell}
    t0 = time.perf_counter()
    card = AIMNet2Calculator((params, cfg), device="cuda").eval(data, forces=True, stress=True)
    torch.cuda.synchronize()
    t_card = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu = AIMNet2Calculator((params_to(params, torch.device("cpu")), cfg), device="cpu").eval(
        data, forces=True, stress=True
    )
    t_cpu = time.perf_counter() - t0
    de = abs(float(card["energy"][0] - cpu["energy"][0]))
    df = float(np.abs(card["forces"] - cpu["forces"]).max())
    ds = float(np.abs(card["stress"] - cpu["stress"]).max())
    log(f"[check] {N_CHECK} atoms: E card {card['energy'][0]:.6f} cpu {cpu['energy'][0]:.6f} "
        f"|dE| {de:.3e} eV; max |dF| {df:.3e} eV/A; max |dstress| {ds:.3e} eV/A^3 "
        f"(card {t_card:.1f} s, cpu {t_cpu:.1f} s)")
    if de > REL_TOL * abs(float(cpu["energy"][0])) or df > 1e-4 or ds > 1e-6:
        raise SystemExit("FAIL: the card and the CPU run disagree")
    return {"dE": de, "dF": df, "dstress": ds, "card_s": t_card, "cpu_s": t_cpu}


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", help="write the full results as JSON to this file")
    args = parser.parse_args()
    smi = phase_card()
    sys.path.insert(0, ROOT)
    import torch

    from aimnetcentral_tpu_torch.calculators import AIMNet2Calculator
    from aimnetcentral_tpu_torch.models import aimnet2_init

    results: dict = {"card": smi}
    results["build"] = phase_build()

    cfg = flagship_config()
    params = aimnet2_init(cfg, seed=0, device="cuda")
    calc = AIMNet2Calculator((params, cfg), device="cuda")
    coord, numbers, cell = build_box(N_MAIN)
    kernels, results["kernels_detail"] = phase_kernels(calc, coord, numbers, cell)
    results["main"] = phase_main_path(calc, coord, numbers, cell)
    for k in kernels:
        k["launches"] = results["main"]["launches"][k["name"]]
    results["layers"] = phase_layers(calc, coord, numbers, cell)
    results["check"] = phase_card_vs_cpu(params, cfg)

    if args.out:
        with open(args.out, "w") as fh:
            json.dump({**results, "kernels": kernels}, fh, indent=1, default=str)
    log(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                   "count": torch.cuda.device_count()},
    }))


if __name__ == "__main__":
    main()
