"""Streaming regression metrics: MAE / RMSE / R^2 per target (counterpart
of aimnetcentral_tpu/train/metrics.py).

``RegMultiMetric`` accumulates on the host in float64 numpy, as the JAX
package's does; ``batch_stats`` is the same accumulator contribution as
tensors on the batch's device, which ``RegMultiMetric.update_from_stats``
merges.  Across ranks: :func:`reduce_stats` sums ``batch_stats`` over a
mesh axis (JAX's ``psum`` over ``dp``), :func:`allreduce_accumulators`
sums the host accumulators in float64 over a mesh or the default world
(``compute(multihost=True)``).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

EV2KCAL = 23.060547830619026  # eV -> kcal/mol


@dataclasses.dataclass
class MetricConfig:
    key_pred: str
    key_true: str
    peratom: bool = False  # normalize counts by atoms instead of molecules
    scale: float = 1.0  # e.g. EV2KCAL for reporting


class RegMultiMetric:
    """Accumulates sum/abs-sum/sq-sum statistics per target."""

    def __init__(self, configs: list[MetricConfig]):
        self.configs = configs
        self.reset()

    def reset(self) -> None:
        self._acc = {
            c.key_pred: {"n": 0.0, "sum_err": 0.0, "sum_abs": 0.0, "sum_sq": 0.0, "sum_true": 0.0,
                         "sum_true_sq": 0.0}
            for c in self.configs
        }

    def update(self, pred: dict, true: dict, weights: dict | None = None) -> None:
        """Accumulate one batch on the host (numpy; padding excluded by a
        per-target boolean mask in ``weights``)."""
        for c in self.configs:
            if c.key_true not in true or c.key_pred not in pred:
                continue
            p = np.asarray(pred[c.key_pred], dtype=np.float64).ravel()
            t = np.asarray(true[c.key_true], dtype=np.float64).ravel()
            if weights and c.key_pred in weights:
                w = np.asarray(weights[c.key_pred], dtype=bool).ravel()
                # broadcast per-atom masks over vector components
                if w.shape[0] != p.shape[0] and p.shape[0] % w.shape[0] == 0:
                    w = np.repeat(w, p.shape[0] // w.shape[0])
                p, t = p[w], t[w]
            err = p - t
            a = self._acc[c.key_pred]
            a["n"] += len(err)
            a["sum_err"] += err.sum()
            a["sum_abs"] += np.abs(err).sum()
            a["sum_sq"] += (err**2).sum()
            a["sum_true"] += t.sum()
            a["sum_true_sq"] += (t**2).sum()

    def update_from_stats(self, stats: dict[str, dict[str, Any]]) -> None:
        """Merge ``batch_stats`` results into the host accumulators."""
        for key, st in stats.items():
            a = self._acc[key]
            for f, v in st.items():
                a[f] += float(v)

    def compute(self, multihost: bool = False) -> dict[str, float]:
        """``multihost=True`` sums the accumulators over the processes of
        the default world first (:func:`allreduce_accumulators_multihost`)."""
        if multihost:
            self._acc = allreduce_accumulators_multihost(self._acc)
        out: dict[str, float] = {}
        for c in self.configs:
            a = self._acc[c.key_pred]
            n = max(a["n"], 1.0)
            mae = a["sum_abs"] / n * c.scale
            rmse = np.sqrt(a["sum_sq"] / n) * c.scale
            var = a["sum_true_sq"] / n - (a["sum_true"] / n) ** 2
            r2 = 1.0 - (a["sum_sq"] / n) / var if var > 0 else float("nan")
            out[f"{c.key_pred}_mae"] = float(mae)
            out[f"{c.key_pred}_rmse"] = float(rmse)
            out[f"{c.key_pred}_r2"] = float(r2)
        return out


def batch_stats(pred: torch.Tensor, true: torch.Tensor, mask: torch.Tensor | None = None) -> dict[str, torch.Tensor]:
    """One target's accumulator contribution as float32 tensors on the
    batch's device (no host sync until ``update_from_stats`` reads them)."""
    p = pred.reshape(-1).to(torch.float32)
    t = true.reshape(-1).to(torch.float32)
    if mask is not None:
        m = mask.reshape(-1)
        if m.shape[0] != p.shape[0] and p.shape[0] % m.shape[0] == 0:
            m = torch.repeat_interleave(m, p.shape[0] // m.shape[0])
        m = m.to(torch.float32)
    else:
        m = torch.ones_like(p)
    err = (p - t) * m
    return {
        "n": m.sum(),
        "sum_err": err.sum(),
        "sum_abs": err.abs().sum(),
        "sum_sq": (err * err).sum(),
        "sum_true": (t * m).sum(),
        "sum_true_sq": (t * t * m).sum(),
    }


def reduce_stats(stats: dict[str, Any], mesh, axis: str = "dp") -> dict[str, Any]:
    """``batch_stats`` results (one dict per target, or one target's dict)
    summed over the ranks of ``mesh`` that share this rank's other
    coordinates (its line along ``axis``): JAX's ``reduce_stats``, a
    ``psum`` over the axis."""
    from aimnetcentral_tpu_torch.parallel.collectives import all_reduce_sum

    if all(isinstance(v, torch.Tensor) for v in stats.values()):
        keys = sorted(stats)
        total = all_reduce_sum(torch.stack([stats[k].reshape(()) for k in keys]), mesh.sub((axis,)))
        return {k: total[i] for i, k in enumerate(keys)}
    return {k: reduce_stats(v, mesh, axis) for k, v in stats.items()}


def allreduce_accumulators(acc: dict[str, dict[str, float]], mesh) -> dict[str, dict[str, float]]:
    """Host accumulators summed in float64 over the ranks of ``mesh``."""
    from aimnetcentral_tpu_torch.parallel.collectives import all_reduce_sum

    keys = sorted(acc)
    fields = sorted(next(iter(acc.values())))
    local = torch.tensor([[acc[k][f] for f in fields] for k in keys], dtype=torch.float64)
    total = all_reduce_sum(local.to(mesh.device), mesh).cpu().numpy()
    return {k: {f: float(total[i, j]) for j, f in enumerate(fields)} for i, k in enumerate(keys)}


def allreduce_accumulators_multihost(acc: dict[str, dict[str, float]]) -> dict[str, dict[str, float]]:
    """Host accumulators summed in float64 over every process of the
    default world (multi-process data-parallel evaluation); unchanged in
    one process."""
    import torch.distributed as dist

    if not dist.is_initialized() or dist.get_world_size() == 1:
        return acc
    from aimnetcentral_tpu_torch.parallel.mesh import world_mesh

    return allreduce_accumulators(acc, world_mesh())
