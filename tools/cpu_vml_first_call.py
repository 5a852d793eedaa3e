#!/usr/bin/env python3
"""How often the first multi-threaded call into torch's CPU vector math
goes wrong, with and without one call on the calling thread before it.

    python3 tools/cpu_vml_first_call.py [--procs 48] [--threads 3] [--jobs 4]

On CPU float tensors torch computes exp, sqrt, cos, log, tanh and a few
more through MKL's vector-math library (VML).  Each fresh process here
sets its thread count, makes one LAPACK call (the QR that
``torch.nn.init.orthogonal_`` makes, as the port's ``aimnet2_init`` does),
then runs the first steps of kernel A's plain version on a seeded
500-atom-like layout (27 bins of 40 slots): a gather by a neighbour-bin
table, the masked squared distances, and their square root, whose 43,200
elements torch splits into one chunk a thread.  A process counts as wrong
when any root is more than 2 units in the last place from the float64
root.  With ``--warm`` each process first calls ``torch.exp`` on one
element (on the calling thread only), as ``aimnetcentral_tpu_torch``
does when it is imported.  It imports nothing of the port."""

import argparse
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

CHILD = r"""
import sys
import numpy as np
import torch

torch.set_num_threads(int(sys.argv[1]))
if sys.argv[2] == "warm":
    torch.exp(torch.zeros(1))
torch.nn.init.orthogonal_(torch.empty(64, 256))
rng = np.random.default_rng(0)
b, c = 27, 40
coord = torch.as_tensor(rng.uniform(0.0, 17.7, size=(b, c, 3)).astype(np.float32))
mask = torch.as_tensor((rng.uniform(size=(b, c)) < 0.5).astype(np.float32))
nbr = torch.as_tensor(rng.permutation(b))
cj = coord[nbr] + torch.as_tensor(rng.normal(size=(b, 1, 3)).astype(np.float32))
diff = cj[:, None, :, :] - coord[:, :, None, :]
d2 = (diff * diff).sum(-1)
vp = (mask > 0.5)[:, :, None] & (mask[nbr] > 0.5)[:, None, :]
x = torch.where(vp, d2, torch.ones_like(d2))
d = torch.sqrt(x)
exact = torch.sqrt(x.double())
ulp = (exact.float().view(torch.int32) - d.view(torch.int32)).abs()
print(int((ulp > 2).sum()), int(ulp.max()))
"""


def one(args) -> tuple[int, int]:
    threads, mode = args
    out = subprocess.run([sys.executable, "-c", CHILD, str(threads), mode], capture_output=True, text=True,
                         check=True).stdout.split()
    return int(out[0]), int(out[1])


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--procs", type=int, default=48, help="fresh processes a mode")
    parser.add_argument("--threads", type=int, default=3, help="torch threads in each process")
    parser.add_argument("--jobs", type=int, default=4, help="processes at a time")
    args = parser.parse_args()
    for mode in ("cold", "warm"):
        with ThreadPoolExecutor(args.jobs) as pool:
            res = list(pool.map(one, [(args.threads, mode)] * args.procs))
        bad = [r for r in res if r[0]]
        worst = max((r[1] for r in res), default=0)
        print(f"{mode}: {len(bad)} of {args.procs} processes had square roots more than 2 ulp off "
              f"(elements off in each: {sorted(r[0] for r in bad)}; largest error {worst} ulp)")


if __name__ == "__main__":
    main()
