"""The training loop: epochs, validation, checkpoints, learning-rate
scheduling (counterpart of aimnetcentral_tpu/train/trainer.py).

- one train step per batch, each size group one batch shape;
- validation each epoch at the training tier, with streaming metrics;
- a ReduceLROnPlateau-style scheduler, TerminateOnNaN and TerminateOnLowLR;
- checkpoints in the JAX package's npz layout, so a checkpoint written by
  either package resumes in the other (:func:`save_checkpoint`);
- a JSONL metrics log, or a tracker (``train/trackers.py``);
- data parallelism over the ranks of a ``parallel.make_mesh`` mesh: each
  host batch split into one microbatch a rank as JAX splits it over its
  devices, the step's gradient averaged over the ranks
  (``train/step.py``), the validation losses and metrics reduced over
  them; only the mesh's lead rank writes files.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Any, Mapping

import numpy as np
import torch

from aimnetcentral_tpu_torch.calculators.calculator import ambient_matmul_context
from aimnetcentral_tpu_torch.data.sgdataset import SizeGroupedDataset, SizeGroupedSampler
from aimnetcentral_tpu_torch.device import resolve_device
from aimnetcentral_tpu_torch.models.aimnet2 import AIMNet2Config
from aimnetcentral_tpu_torch.models.bridge import params_to
from aimnetcentral_tpu_torch.train.loss import LossConfig, MTLoss
from aimnetcentral_tpu_torch.train.metrics import MetricConfig, RegMultiMetric
from aimnetcentral_tpu_torch.train.step import (
    TrainState,
    ambient_for,
    detached,
    get_learning_rate,
    init_train_state,
    make_optimizer,
    make_train_step,
    predict,
    set_learning_rate,
    tree_leaves,
    tree_unflatten,
)
from aimnetcentral_tpu_torch.train.trackers import DEFAULT_PROJECT


@dataclasses.dataclass
class TrainerConfig:
    max_epochs: int = 100
    batch_size: int = 64
    batch_mode: str = "molecules"
    learning_rate: float = 1e-3
    grad_clip: float = 0.4
    weight_decay: float = 0.0
    lr_factor: float = 0.5  # plateau decay
    lr_patience: int = 5  # epochs without validation improvement
    terminate_low_lr: float = 1e-6
    checkpoint_dir: str | None = None
    log_file: str | None = None
    tracker: str | None = None  # None | "jsonl" | "wandb"
    tracker_project: str = DEFAULT_PROJECT
    tracker_run_name: str | None = None
    seed: int = 0
    with_forces: bool = True
    # "packed": the molecule-bin layout (kernels A, B, D, E on the card);
    # "indexed": flat all-pairs neighbor matrices
    layout: str = "packed"
    # the train step's matmul tier: "fast" (TF32, the default) or "exact"
    precision: str = "fast"


# ---------------------------------------------------------------------------
# checkpoints: the JAX package's npz layout


def _opt_leaves(state: TrainState) -> list[np.ndarray]:
    """The optimizer state as the leaves of the JAX package's optax chain
    for ``make_optimizer``: Adam's count (int32), its ``mu`` leaf by leaf in
    parameter order, its ``nu`` likewise, the injected hyperparameters'
    count (int32) and the learning rate (float32).  A leaf Adam does not
    hold (a frozen table, or before the first step) has zero moments."""
    adam = state.opt_state
    count = 0
    mus, nus = [], []
    for _path, leaf in tree_leaves(state.params):
        st = adam.state.get(leaf, {}) if leaf.requires_grad else {}
        if "step" in st:
            count = int(st["step"])
        zeros = np.zeros(tuple(leaf.shape), dtype=np.float32)
        mus.append(st["exp_avg"].detach().cpu().numpy() if "exp_avg" in st else zeros)
        nus.append(st["exp_avg_sq"].detach().cpu().numpy() if "exp_avg_sq" in st else zeros)
    lr = np.asarray(get_learning_rate(adam), dtype=np.float32)
    return [np.asarray(count, np.int32), *mus, *nus, np.asarray(count, np.int32), lr]


def save_checkpoint(path: str, state: TrainState, scheduler: Mapping[str, float] | None = None) -> None:
    """Parameters, the full optimizer state and the scheduler's bookkeeping
    in one npz, keyed as the JAX package keys it: ``p{i}`` the parameters in
    its flatten order (dict keys sorted, lists in order), ``o{i}`` the optax
    state's leaves (:func:`_opt_leaves`), ``__step__`` and
    ``__sched_{lr,plateau,best_val}__``.  Either package resumes the other's."""
    payload = {
        "__step__": int(state.step),
        **{f"p{i}": x.detach().cpu().numpy() for i, (_p, x) in enumerate(tree_leaves(state.params))},
        **{f"o{i}": x for i, x in enumerate(_opt_leaves(state))},
    }
    for k, v in (scheduler or {}).items():
        payload[f"__sched_{k}__"] = float(v)
    np.savez(path, **payload)


def load_checkpoint_params(path: str, params_template: Any) -> Any:
    """The checkpoint's parameters in ``params_template``'s tree, each leaf
    on its template leaf's device and with its dtype."""
    with np.load(path) as z:
        leaves = [
            torch.as_tensor(np.asarray(z[f"p{i}"]), device=t.device).to(t.dtype)
            for i, (_p, t) in enumerate(tree_leaves(params_template))
        ]
    return tree_unflatten(params_template, leaves)


def load_checkpoint_full(path: str, state_template: TrainState) -> tuple[TrainState, dict[str, float]]:
    """Restore the parameters, Adam's moments and count, the learning rate
    and the step into a state like ``state_template`` (whose optimizer
    settings it keeps), and return the scheduler dict.  A checkpoint without
    optimizer leaves (weights only) restores the parameters and keeps a
    fresh optimizer."""
    with np.load(path) as z:
        files = set(z.files)
        params = load_checkpoint_params(path, state_template.params)
        state = init_train_state(params, state_template.optimizer)
        set_learning_rate(state.opt_state, get_learning_rate(state_template.opt_state))
        if "o0" in files:
            named = tree_leaves(state.params)
            n = len(named)
            if f"o{2 * n + 2}" not in files or f"o{2 * n + 3}" in files:
                raise ValueError(f"{path}: the optimizer state does not have the leaves of make_optimizer's "
                                 f"chain for {n} parameters")
            count = int(z["o0"])
            adam = state.opt_state
            for i, (_p, leaf) in enumerate(named):
                if leaf.requires_grad and count > 0:
                    adam.state[leaf] = {
                        "step": torch.tensor(float(count), dtype=torch.float32),
                        "exp_avg": torch.as_tensor(np.asarray(z[f"o{1 + i}"]), device=leaf.device).to(leaf.dtype),
                        "exp_avg_sq": torch.as_tensor(np.asarray(z[f"o{1 + n + i}"]),
                                                      device=leaf.device).to(leaf.dtype),
                    }
            set_learning_rate(adam, float(z[f"o{2 * n + 2}"]))
        state.step = int(z["__step__"]) if "__step__" in files else state_template.step
        sched = {k[len("__sched_"):-2]: float(z[k]) for k in z.files if k.startswith("__sched_")}
    return state, sched


def spread_padding(system, n_mol: int, size: int):
    """An indexed microbatch (``make_batch_system``'s, ``n_mol`` molecules
    of ``size`` atoms padded to ``system.num_mol``) with its padded
    molecules' atoms moved 1, 2, 3, ... A along x from the point where
    ``make_batch_system`` stacks them.  Stacked, each padded atom is at zero distance
    from its neighbours, and the force loss's gradient is NaN in both
    packages (ROADMAP.md section 3); apart, their energies, forces and
    charges stay 0 and the loss is the same."""
    lo, hi = n_mol * size, system.num_mol * size
    if hi == lo:
        return system
    coord = system.coord.clone()
    coord[lo:hi, 0] += torch.arange(1, hi - lo + 1, dtype=coord.dtype, device=coord.device)
    return system.replace(coord=coord)


# ---------------------------------------------------------------------------
# the trainer


class Trainer:
    """Fit ``params`` of ``cfg`` on ``train_ds``; validate on ``val_ds``
    each epoch.  Runs on ``device`` (the card unless ``"cpu"``).

    ``mesh`` (``parallel.make_mesh``'s, ``dp`` by ``ens``): every rank of
    the mesh constructs the trainer and calls ``fit`` alike, on its mesh
    device; the parameters are the mesh's first rank's, replicated."""

    def __init__(
        self,
        cfg: AIMNet2Config,
        params: Any,
        train_ds: SizeGroupedDataset,
        val_ds: SizeGroupedDataset | None = None,
        tcfg: TrainerConfig = TrainerConfig(),
        loss_cfg: LossConfig = LossConfig(),
        device: str | torch.device = "cuda",
        mesh=None,
    ):
        if tcfg.layout not in ("packed", "indexed"):
            raise ValueError(f"layout must be 'packed' or 'indexed', got {tcfg.layout!r}")
        self.cfg = cfg
        self.tcfg = tcfg
        self.train_ds = train_ds
        self.val_ds = val_ds
        self.mesh = mesh
        self.n_dev = 1 if mesh is None else mesh.size
        self.device = resolve_device(device) if mesh is None else mesh.device
        self.optimizer = make_optimizer(
            learning_rate=tcfg.learning_rate, grad_clip=tcfg.grad_clip, weight_decay=tcfg.weight_decay
        )
        params = params_to(params, self.device)
        if mesh is not None:
            from aimnetcentral_tpu_torch.parallel.mesh import replicate

            params = replicate(mesh, params)
        self.state = init_train_state(params, self.optimizer)
        self.loss = MTLoss(loss_cfg)
        self._step_fn = make_train_step(cfg, self.loss, self.optimizer, tcfg.with_forces,
                                        precision=tcfg.precision, mesh=mesh)
        self._ambient = ambient_for(tcfg.precision)
        self._lr = tcfg.learning_rate
        self._best_val = float("inf")
        self._plateau = 0

    def resume(self, path: str) -> None:
        """Full resume from a ``save_checkpoint`` file of either package:
        parameters, Adam's moments, the step and the plateau scheduler
        (learning rate, patience counter, best score).  A weights-only
        checkpoint restores the parameters and keeps a fresh optimizer."""
        self.state, sched = load_checkpoint_full(path, self.state)
        if "lr" in sched:
            self._lr = sched["lr"]
            set_learning_rate(self.state.opt_state, self._lr)
        self._plateau = int(sched.get("plateau", 0))
        self._best_val = sched.get("best_val", float("inf"))

    @property
    def lead(self) -> bool:
        """Whether this rank writes checkpoints, logs and tracker records."""
        return self.mesh is None or self.mesh.lead

    def _batch(self, ds: SizeGroupedDataset, size: int, sample: dict):
        """This rank's microbatch of a host batch: JAX's split into
        ``n_dev`` parts of ``ceil(b / n_dev)`` molecules (the last ones
        short or empty), each padded to that many; on the indexed layout
        the padded molecules' atoms are spread apart (:func:`spread_padding`)."""
        b = len(sample["numbers"])
        per_dev = int(np.ceil(b / self.n_dev))
        d = 0 if self.mesh is None else self.mesh.index
        part = {k: v[d * per_dev : (d + 1) * per_dev] for k, v in sample.items()}
        if self.tcfg.layout == "packed":
            return ds.make_batch_system_packed(size, part, pad_mols=per_dev, device=self.device)
        system, labels = ds.make_batch_system(size, part, pad_mols=per_dev, device=self.device)
        return spread_padding(system, len(part["numbers"]), size), labels

    def _mean(self, x: float) -> float:
        """A per-rank number's mean over the mesh."""
        if self.mesh is None:
            return x
        from aimnetcentral_tpu_torch.parallel.collectives import all_reduce_mean

        return float(all_reduce_mean(torch.tensor([x], dtype=torch.float32, device=self.device), self.mesh)[0])

    def train_epoch(self, epoch: int) -> dict[str, float]:
        sampler = SizeGroupedSampler(
            self.train_ds, self.tcfg.batch_size, batch_mode=self.tcfg.batch_mode, shuffle=True,
            seed=self.tcfg.seed + epoch,
        )
        losses = []
        for size, idx in sampler:
            batch, labels = self._batch(self.train_ds, size, self.train_ds[size].sample(idx))
            self.state, metrics = self._step_fn(self.state, batch, labels)
            losses.append(float(metrics["loss"]))
            if not np.isfinite(losses[-1]):
                raise FloatingPointError(f"NaN/inf loss at epoch {epoch} (TerminateOnNaN)")
        return {"train_loss": float(np.mean(losses)) if losses else float("nan")}

    def validate(self) -> dict[str, float]:
        """Loss and MAE / RMSE / R^2 of energy, forces and charges on the
        validation set, at the training tier (checkpoint selection and the
        scheduler read these numbers)."""
        if self.val_ds is None:
            return {}
        sampler = SizeGroupedSampler(self.val_ds, self.tcfg.batch_size, batch_mode=self.tcfg.batch_mode)
        metric = RegMultiMetric([
            MetricConfig(key_pred="energy", key_true="energy"),
            MetricConfig(key_pred="forces", key_true="forces", peratom=True),
            MetricConfig(key_pred="charges", key_true="charges", peratom=True),
        ])
        params = detached(self.state.params)
        losses = []
        for size, idx in sampler:
            batch, labels = self._batch(self.val_ds, size, self.val_ds[size].sample(idx))
            with ambient_matmul_context(self._ambient):
                pred = predict(params, self.cfg, batch, with_forces=True, create_graph=False)
                total, _ = self.loss(pred, labels, batch)
            losses.append(self._mean(float(total.detach())))
            real = (batch.numbers > 0).cpu().numpy().ravel()
            mask = {"forces": real, "charges": real}
            if "energy" in labels:
                mask["energy"] = np.ones(labels["energy"].shape, bool).ravel()
            metric.update(
                {k: v.detach().cpu().numpy() for k, v in pred.items() if k in ("energy", "forces", "charges")},
                {k: v.cpu().numpy() for k, v in labels.items()},
                weights=mask,
            )
        if self.mesh is not None:
            from aimnetcentral_tpu_torch.train.metrics import allreduce_accumulators

            metric._acc = allreduce_accumulators(metric._acc, self.mesh)
        out = metric.compute()
        out["val_loss"] = float(np.mean(losses)) if losses else float("nan")
        return out

    def _checkpoint_scheduler(self) -> dict[str, float]:
        return {"lr": self._lr, "plateau": self._plateau, "best_val": self._best_val}

    def fit(self) -> dict[str, Any]:
        tcfg = self.tcfg
        tracker = None
        if tcfg.tracker and self.lead:
            from aimnetcentral_tpu_torch.train.trackers import make_tracker

            tracker = make_tracker(
                tcfg.tracker, path=tcfg.log_file or "train_log.jsonl", project=tcfg.tracker_project,
                run_name=tcfg.tracker_run_name, config=dataclasses.asdict(tcfg),
            )
        history = []
        for epoch in range(tcfg.max_epochs):
            t0 = time.time()
            tr = self.train_epoch(epoch)
            val = self.validate()
            rec = {"epoch": epoch, "lr": self._lr, "wall_s": round(time.time() - t0, 2), **tr, **val}
            history.append(rec)
            if tcfg.log_file and tcfg.tracker != "jsonl" and self.lead:
                # (the jsonl tracker already writes this record to log_file)
                with open(tcfg.log_file, "a") as f:
                    f.write(json.dumps(rec) + "\n")
            if tracker is not None:
                tracker.log(rec, step=epoch)

            score = val.get("val_loss", tr["train_loss"])
            if score < self._best_val - 1e-12:
                self._best_val = score
                self._plateau = 0
                if tcfg.checkpoint_dir and self.lead:
                    os.makedirs(tcfg.checkpoint_dir, exist_ok=True)
                    save_checkpoint(os.path.join(tcfg.checkpoint_dir, "best.npz"), self.state,
                                    scheduler=self._checkpoint_scheduler())
            else:
                self._plateau += 1
                if self._plateau >= tcfg.lr_patience:
                    self._lr *= tcfg.lr_factor
                    set_learning_rate(self.state.opt_state, self._lr)
                    self._plateau = 0
            if self._lr < tcfg.terminate_low_lr:
                break
        if tracker is not None:
            tracker.finish()
        return {"history": history, "best_val": self._best_val}
