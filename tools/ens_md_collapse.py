"""Where NVE MD of random-weight members and of their ensemble stops
conserving energy, on chip_smoke.py's 10,000-atom flagship box (PyTorch
port, one CUDA card).

Four flagship members (seeds 0-3) at the exact tier, NVE at 0.5 fs from
the same velocities: each member alone for 100 steps, the fused ensemble
for 50 (with every member's energy on its frames, through the single-model
calculator), a central finite difference of the ensemble's mean energy
along its forces at the last frame, the per-member ensemble path
(``AIMNET_ENSEMBLE_FUSED=0``) for 50 steps, and the fused ensemble at
0.1 fs for 250.  Each line: the step, the total energy and its change,
the temperature, the largest force, the driver's rebuilds.

Run from the repository root on a machine with a card:
``python3 tools/ens_md_collapse.py``.
"""
import dataclasses
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))  # chip_smoke.py
import numpy as np

import chip_smoke as S


def main():
    smi = S.phase_card()
    import torch

    from aimnetcentral_tpu_torch import constants
    from aimnetcentral_tpu_torch.calculators import AIMNet2Calculator, stack_params
    from aimnetcentral_tpu_torch.dynamics import MDConfig, MDDriver
    from aimnetcentral_tpu_torch.models import aimnet2_init

    S.phase_build()
    cfg = S.flagship_config()
    members = [aimnet2_init(cfg, seed=s, device="cuda") for s in range(4)]
    ens = stack_params(members)
    coord, numbers, cell = S.build_box(S.N_MAIN)
    dev = torch.device("cuda")
    md = MDConfig(**{**S.MD_SETTING, "thermostat": "nve", "precision": "exact"})
    n = len(numbers)

    def trace(drv, label, steps=100, every=5, frames=False):
        t0 = time.perf_counter()
        drv.state
        et0 = None
        for k in range(steps // every):
            obs = drv.run(every, chunk=every)
            et = obs["epot"].astype(np.float64) + 1.5 * n * constants.kB * obs["temperature"]
            if et0 is None:
                et0 = float(et[0])
            st = drv.state
            fmax = float(st.forces.norm(dim=-1).max())
            row = f"step {(k + 1) * every:4d}: etot {et[-1]:.4f} (d {et[-1] - et0:+.4f}) T {obs['temperature'][-1]:.1f} fmax {fmax:.3f} rebins {drv.rebins}"
            if "epot_std" in obs:
                row += f" std {obs['epot_std'][-1]:.3f}"
            if frames:
                snap = drv.snapshot()
                es = [float(c.eval({"coord": snap["coord"][:n], "numbers": numbers, "cell": cell})["energy"][0]) for c in calcs]
                row += " members " + ", ".join(f"{e:.3f}" for e in es) + f" mean {np.mean(es):.3f} epot {obs['epot'][-1]:.3f}"
            print(f"[{label}] {row}", flush=True)
        print(f"[{label}] {time.perf_counter() - t0:.1f} s", flush=True)

    calcs = [AIMNet2Calculator((p, cfg), device="cuda") for p in members]
    for s in range(4):
        drv = MDDriver(members[s], cfg, S.md_system(coord, numbers, cell, dev), md, seed=0, device="cuda")
        trace(drv, f"member {s} alone 0.5 fs", steps=100)
        del drv
    drv = MDDriver(ens, cfg, S.md_system(coord, numbers, cell, dev), md, ensemble=True, seed=0, device="cuda")
    trace(drv, "ens4 fused 0.5 fs", steps=50, every=5, frames=True)
    # finite differences of the mean energy along the forces, at the end
    st = drv.state
    sysb = st.system
    f = st.forces.detach()
    d = f / f.norm()
    for h in (2e-2, 1e-2, 5e-3):
        ep = drv._force_fn(drv.params, sysb.replace(coord=sysb.coord + h * d))[1].double().sum()
        em = drv._force_fn(drv.params, sysb.replace(coord=sysb.coord - h * d))[1].double().sum()
        print(f"[fd end] h {h}: -(E+ - E-)/2h {float(-(ep - em) / (2 * h)):.5f}  |F| {float(f.norm()):.5f}", flush=True)
    del drv
    os.environ["AIMNET_ENSEMBLE_FUSED"] = "0"
    drv = MDDriver(ens, cfg, S.md_system(coord, numbers, cell, dev), md, ensemble=True, seed=0, device="cuda")
    trace(drv, "ens4 per member 0.5 fs", steps=50, every=5)
    del drv
    os.environ["AIMNET_ENSEMBLE_FUSED"] = "1"
    drv = MDDriver(ens, cfg, S.md_system(coord, numbers, cell, dev), dataclasses.replace(md, dt_fs=0.1), ensemble=True, seed=0, device="cuda")
    trace(drv, "ens4 fused 0.1 fs", steps=250, every=25)
    print(smi)


if __name__ == "__main__":
    main()
