#!/usr/bin/env python3
"""The seconds that chip_smoke.py's smaller card-against-CPU checks save,
measured on one host: each check at its earlier size and at the size the
smoke now runs, in one process, on one card and its host's CPU.

    python3 tools/smoke_cuts.py [--out cuts.json]

The checks (chip_smoke.py's own functions, gates included): the MD check
(wb97m-d3, 1,200 atoms with 10 NVE and 10 FIRE steps against 500 with 3
and 3), the card against the CPU on the flagship and wb97m-d3 boxes, the
DSF cluster, the artifact box and the long_range phase's PME and lr-heads
boxes (1,200 atoms against 500).  Prints each one's seconds (its card and
CPU sides together) and the sums."""

import argparse
import json
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402


def timed(fn, *args, **kw) -> float:
    t0 = time.perf_counter()
    fn(*args, **kw)
    return time.perf_counter() - t0


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", help="write the seconds as JSON to this file")
    args = parser.parse_args()
    smi = cs.phase_card()
    cs.phase_build()
    from aimnetcentral_tpu_torch.models import aimnet2_init
    from aimnetcentral_tpu_torch.train.export import export_model

    cfg, cfg_d3 = cs.flagship_config(), cs.wb97m_d3_config()
    params = aimnet2_init(cfg, seed=0, device="cuda")
    params_d3 = aimnet2_init(cfg_d3, seed=0, device="cuda")
    params_lr, cfg_lr = cs.lr_heads_model(cfg)
    cfg_pme = cs.ewald_config(cfg, "pme")
    old, new = cs.N_CHECK, cs.CHECK_BOX
    seconds = {}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "artifact.pt")
        export_model(params_d3, cfg_d3, path, sae=cs.ARTIFACT_SAE, implemented_species=cs.ARTIFACT_SPECIES)

        def box(n):
            c, z, cell = cs.build_box(n, seed=1)
            return {"coord": c, "numbers": z, "cell": cell}

        checks = {
            "md_check": (lambda n, s: cs.phase_md_card_vs_cpu("wb97m-d3", params_d3, cfg_d3, n_box=n, steps=s),
                         (old, 10), (new, cs.MD_CHECK_STEPS)),
            "check flagship": (lambda n: cs.phase_card_vs_cpu("flagship", params, cfg, n_box=n), (old,), (new,)),
            "check wb97m-d3": (lambda n: cs.phase_card_vs_cpu("wb97m-d3", params_d3, cfg_d3, n_box=n), (old,),
                               (new,)),
            "cluster-dsf": (lambda n, t: cs.gas_card_vs_cpu(f"cluster-{n}-dsf", params, cs.dsf_config(cfg),
                                                            cs.gas_cluster(n, seed=5), False, t),
                            (old, 1024), (new, cs.CHECK_THRESHOLD)),
            "artifact box": (lambda n, t: cs.artifact_card_vs_cpu(f"artifact-{n}", path, box(n), True, t),
                             (old, 1024), (new, cs.CHECK_THRESHOLD)),
            "pme box": (lambda n: cs.phase_card_vs_cpu(f"pme-{n}", params, cfg_pme, n_box=n), (old,), (new,)),
            "lr-heads box": (lambda n: cs.phase_card_vs_cpu(f"lr-heads-{n}", params_lr, cfg_lr, n_box=n), (old,),
                             (new,)),
        }
        for name, (fn, before, after) in checks.items():
            seconds[name] = {"before": timed(fn, *before), "after": timed(fn, *after)}
            cs.log(f"[cuts] {name}: {before} {seconds[name]['before']:.1f} s -> {after} "
                   f"{seconds[name]['after']:.1f} s")
    total = {k: sum(v[k] for v in seconds.values()) for k in ("before", "after")}
    cs.log(f"[cuts] all: {total['before']:.1f} s -> {total['after']:.1f} s, saved "
           f"{total['before'] - total['after']:.1f} s ({smi})")
    if args.out:
        with open(args.out, "w") as fh:
            json.dump({"card": smi, "seconds": seconds, "total": total}, fh, indent=1)


if __name__ == "__main__":
    main()
