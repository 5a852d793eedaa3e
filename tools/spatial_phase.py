#!/usr/bin/env python3
"""chip_smoke.py's spatial phase alone (after its card and build phases):

    python3 tools/spatial_phase.py

One world of four ranks on the flagship-10k box (a ring of two, the 2 x 2
torus, SpatialMDDriver, ewald-d3-10k and pme-d3-10k on the ring), each held
to the single-device port.  With one card the ranks share it through gloo
(staged through the host); with four, NCCL puts a rank on each card."""

import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke as cs  # noqa: E402

if __name__ == "__main__":
    t0 = time.perf_counter()
    smi = cs.phase_card()
    cs.phase_build()
    from aimnetcentral_tpu_torch.models import aimnet2_init

    cfg, cfg_d3 = cs.flagship_config(), cs.wb97m_d3_config()
    params = aimnet2_init(cfg, seed=0, device="cuda")
    params_d3 = aimnet2_init(cfg_d3, seed=0, device="cuda")
    coord, numbers, cell = cs.build_box(cs.N_MAIN)
    res = cs.phase_spatial(params, cfg, params_d3, cfg_d3, coord, numbers, cell)
    print(f"total {time.perf_counter() - t0:.1f} s; backend {res['backend']}; {smi}")
