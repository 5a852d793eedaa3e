#!/usr/bin/env python3
"""Where the time of one chip_smoke.py MD window goes, on one card: a
flagship-10k driver (chip_smoke.py's box and MD setting) built, its
initial forces, 50 warm-up steps, 100 timed steps, then a profiled chunk
of 25 steps, one of 5 and one of 25 again, each with the wall time of the
profiler's ``key_averages()`` read twice (the first read builds the
averages), then 50 NVE steps of a fresh driver.

    python3 tools/md_profile_cost.py

Run from the repository root on a machine with a CUDA card; prints one
line a piece and the card's name and power limit."""

import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402


def main() -> None:
    smi = cs.phase_card()
    cs.phase_build()
    import torch
    from torch.profiler import ProfilerActivity, profile

    from aimnetcentral_tpu_torch.dynamics import MDConfig, MDDriver
    from aimnetcentral_tpu_torch.models import aimnet2_init

    cfg = cs.flagship_config()
    params = aimnet2_init(cfg, seed=0, device="cuda")
    coord, numbers, cell = cs.build_box(cs.N_MAIN)
    system = cs.md_system(coord, numbers, cell, "cuda")

    def timed(label, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        print(f"{label}: {time.perf_counter() - t0:.2f} s", flush=True)
        return out

    drv = timed("driver", lambda: MDDriver(params, cfg, system, MDConfig(**cs.MD_SETTING), seed=0, device="cuda"))
    timed("initial forces", lambda: drv.state)
    timed("warm-up 50", lambda: drv.run(50, chunk=25))
    timed("window 100", lambda: drv.run(100, chunk=25))
    for n in (25, 5, 25):
        def profiled(n=n):
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                drv.run(n, chunk=n)
                torch.cuda.synchronize()
            return prof

        prof = timed(f"profiled {n} steps", profiled)
        timed(f"key_averages of {n}", lambda: cs.device_busy_ms(prof))
        timed(f"key_averages again {n}", lambda: sorted(
            (e for e in prof.key_averages() if cs.on_device(e)), key=cs.dev_us))
    nve = MDDriver(params, cfg, system, MDConfig(**{**cs.MD_SETTING, "thermostat": "nve"}), seed=0, device="cuda")
    timed("nve initial", lambda: nve.state)
    timed("nve 50", lambda: nve.run(50, chunk=25))
    print(smi)


if __name__ == "__main__":
    main()
