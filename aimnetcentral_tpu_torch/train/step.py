"""The training step: loss, parameter gradient and optimizer update
(counterpart of aimnetcentral_tpu/train/step.py, on one device).

The force loss takes the forces by ``torch.autograd.grad(create_graph=True)``
of the energy and then the loss's parameter gradient: a second derivative
through every conv pass and pair sweep.  On molecule bins its primal and
first adjoints run kernels A, B (in its AEV-constants build), D and E, and
its second-order tangents the plain versions (kernels/conv_pass.py::
ConvAcc, kernels/pair_sweep.py::PairAcc), as the JAX package runs them on
its XLA twin.

Data parallelism (``mesh``): each rank of a ``parallel.make_mesh`` mesh
takes its own microbatch, and the step's gradient is the mean over the
mesh's ranks of their microbatch gradients, as JAX's loss is the mean
over its stacked microbatches.  One flat buffer (the gradients, the loss
and its components) goes through ``parallel.collectives.all_reduce_mean``
before the clip and Adam, so every rank applies the same update and the
replicated parameters stay the same bits on every rank.

The optimizer is ``torch.optim.Adam`` behind a global-norm clip, after the
JAX package's optax chain ``clip_by_global_norm -> add_decayed_weights ->
scale_by_adam -> [per-group scale] -> scale_by_learning_rate``.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any

import numpy as np
import torch

from aimnetcentral_tpu_torch.calculators.calculator import ambient_matmul_context, precision_tiers
from aimnetcentral_tpu_torch.models.aimnet2 import AIMNet2Config, aimnet2_apply
from aimnetcentral_tpu_torch.system import System
from aimnetcentral_tpu_torch.train.loss import MTLoss

D3_TABLES = ("rcov", "r4r2", "c6ab", "cn_ref")
ADAM_BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8


# ---------------------------------------------------------------------------
# parameter trees


def tree_leaves(tree: Any, prefix: str = "") -> list[tuple[str, Any]]:
    """``(path, leaf)`` in the JAX package's flatten order (dict keys sorted,
    lists in order), each path the ``/``-joined keys and indices, as
    ``make_optimizer``'s parameter groups match them in the JAX package."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k], f"{prefix}{k}/")]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree) for x in tree_leaves(v, f"{prefix}{i}/")]
    return [(prefix[:-1], tree)]


def tree_unflatten(tree: Any, leaves: list) -> Any:
    """``tree`` with its leaves replaced, in ``tree_leaves``' order, from
    ``leaves``."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        if isinstance(node, (list, tuple)):
            return type(node)(build(v) for v in node)
        return next(it)

    return build(tree)


def is_trainable(params: dict, path: str) -> bool:
    """Every floating parameter leaf is trained except the DFT-D3 head's
    reference tables ``rcov``, ``r4r2``, ``c6ab`` and ``cn_ref``.

    Those are Grimme's published data, not weights.  The JAX package trains
    them too, and its gradient with respect to ``r4r2`` is NaN on every
    layout (0 x inf where a real atom pairs with padding), which makes the
    global norm and then every parameter NaN after one step; the port holds
    them constant instead (a difference of definition, ROADMAP.md section
    3).  A head is the D3 head when its parameters are exactly these four
    tables; D3TS's own ``r4r2`` is trained."""
    parts = path.split("/")
    if len(parts) == 3 and parts[0] == "outputs" and parts[2] in D3_TABLES:
        head = params["outputs"][parts[1]]
        if set(head) == set(D3_TABLES):
            return False
    return True


# ---------------------------------------------------------------------------
# the optimizer


@dataclasses.dataclass(frozen=True)
class Optimizer:
    """Adam with global-norm clipping, decoupled from any parameter tree
    until :meth:`init` (the port's counterpart of the optax
    ``GradientTransformation`` that ``make_optimizer`` returns in JAX).

    ``param_group_lr``: ``(regex, multiplier)`` pairs; a leaf takes the
    first pattern that matches its path (``tree_leaves``) and its learning
    rate times that multiplier."""

    learning_rate: float = 1e-3
    grad_clip: float = 0.4
    weight_decay: float = 0.0
    param_group_lr: tuple[tuple[str, float], ...] = ()

    def multiplier(self, path: str) -> float:
        for pat, mult in self.param_group_lr:
            if re.search(pat, path):
                return float(mult)
        return 1.0

    def init(self, named: list[tuple[str, torch.Tensor]]) -> torch.optim.Adam:
        """``torch.optim.Adam`` over the trainable leaves, one parameter
        group per learning-rate multiplier (``lr_mult``)."""
        groups: dict[float, list[torch.Tensor]] = {}
        for path, leaf in named:
            groups.setdefault(self.multiplier(path), []).append(leaf)
        adam = torch.optim.Adam(
            [{"params": ps, "lr_mult": m} for m, ps in groups.items()],
            lr=self.learning_rate, betas=ADAM_BETAS, eps=ADAM_EPS, weight_decay=self.weight_decay,
        )
        set_learning_rate(adam, self.learning_rate)
        return adam

    def clip(self, grads: list[torch.Tensor]) -> tuple[list[torch.Tensor], torch.Tensor]:
        """optax's ``clip_by_global_norm``: ``g`` where the global norm is
        below ``grad_clip``, else ``(g / norm) * grad_clip`` (no epsilon:
        ``torch.nn.utils.clip_grad_norm_`` adds 1e-6 to the norm).  Returns
        the clipped gradients and the unclipped norm, without a host sync."""
        norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
        keep = norm < self.grad_clip
        return [torch.where(keep, g, (g / norm) * self.grad_clip) for g in grads], norm

    def apply(self, adam: torch.optim.Adam, leaves: list[torch.Tensor], grads: list[torch.Tensor]) -> torch.Tensor:
        """Clip, hand the gradients to Adam and step; returns the global
        norm.  ``weight_decay`` is added to the clipped gradient inside
        Adam's step, as ``optax.add_decayed_weights`` adds it before
        ``scale_by_adam``."""
        clipped, norm = self.clip(grads)
        for leaf, g in zip(leaves, clipped):
            leaf.grad = g
        adam.step()
        for leaf in leaves:
            leaf.grad = None
        return norm


def make_optimizer(
    learning_rate: float = 1e-3,
    grad_clip: float = 0.4,
    weight_decay: float = 0.0,
    param_group_lr: dict[str, float] | None = None,
) -> Optimizer:
    """Adam (beta 0.9 / 0.999, eps 1e-8) with global-norm clipping (0.4) and
    optional regex parameter-group learning-rate multipliers."""
    return Optimizer(float(learning_rate), float(grad_clip), float(weight_decay),
                     tuple((param_group_lr or {}).items()))


def set_learning_rate(adam: torch.optim.Adam, lr: float) -> torch.optim.Adam:
    """Set the base learning rate (for the plateau scheduler); each group
    runs at it times its multiplier.  Held as float32, as optax's injected
    hyperparameter is."""
    lr32 = float(np.float32(lr))
    for group in adam.param_groups:
        group["base_lr"] = lr32
        group["lr"] = lr32 * group["lr_mult"]
    return adam


def get_learning_rate(adam: torch.optim.Adam) -> float | None:
    return adam.param_groups[0]["base_lr"] if adam.param_groups else None


# ---------------------------------------------------------------------------
# precision tiers


def ambient_for(precision: str) -> str:
    """A training tier's matmul precision, through the calculator's single
    mapping (``precision_tiers``).  Training takes ``fast`` (TF32 matmuls,
    the default) and ``exact`` (TF32 off) only, as JAX's (train/step.py::
    ambient_for); the conv precision is then ``None``: kernels A and B run
    in one TF32 pass at ``fast`` (conv_pass.resolve_conv_mode)."""
    if precision not in ("fast", "exact"):
        raise ValueError(f"train precision must be 'fast' or 'exact', got {precision!r}")
    return precision_tiers(precision)[0]


# ---------------------------------------------------------------------------
# the state and the step


@dataclasses.dataclass
class TrainState:
    """The parameter tree (trainable leaves require grad), the Adam
    instance over them, their paths, the optimizer's settings and the step
    count.  A step updates the leaves and Adam's state in place."""

    params: dict
    opt_state: torch.optim.Adam
    trainable: list[tuple[str, torch.Tensor]]
    optimizer: Optimizer
    step: int = 0


def init_train_state(params: dict, optimizer: Optimizer) -> TrainState:
    """Copies of ``params``' leaves (trainable ones as leaves that require
    grad; see :func:`is_trainable`) and a fresh Adam over them."""
    named = []
    leaves = []
    for path, x in tree_leaves(params):
        leaf = x.detach().clone()
        if leaf.is_floating_point() and is_trainable(params, path):
            leaf.requires_grad_(True)
            named.append((path, leaf))
        leaves.append(leaf)
    tree = tree_unflatten(params, leaves)
    return TrainState(params=tree, opt_state=optimizer.init(named), trainable=named, optimizer=optimizer)


def detached(params: Any) -> Any:
    """The parameter tree without autograd (validation, export)."""
    return tree_unflatten(params, [x.detach() for _p, x in tree_leaves(params)])


def predict(params: dict, cfg: AIMNet2Config, system: System, with_forces: bool, create_graph: bool) -> dict:
    """The model's outputs without SAE and, ``with_forces``, the forces as
    ``-dE/dx`` (kept differentiable with ``create_graph``)."""
    if not with_forces:
        return aimnet2_apply(params, cfg, system, sae_external=False)
    coord = system.coord.detach().requires_grad_(True)
    out = aimnet2_apply(params, cfg, system.replace(coord=coord), sae_external=False)
    (g,) = torch.autograd.grad(out["energy"].sum(), coord, create_graph=create_graph)
    return {**out, "forces": -g}


def mean_over_mesh(mesh, grads: list[torch.Tensor], scalars: dict[str, torch.Tensor]):
    """The gradients and the 0-d ``scalars`` averaged over the mesh's ranks
    in one flat buffer (``collectives.all_reduce_mean``)."""
    from aimnetcentral_tpu_torch.parallel.collectives import all_reduce_mean

    keys = list(scalars)
    flat = torch.cat([g.reshape(-1) for g in grads] + [scalars[k].reshape(1).to(grads[0].dtype) for k in keys])
    flat = all_reduce_mean(flat, mesh)
    out, at = [], 0
    for g in grads:
        out.append(flat[at : at + g.numel()].view_as(g))
        at += g.numel()
    return out, {k: flat[at + i] for i, k in enumerate(keys)}


def make_train_step(
    cfg: AIMNet2Config,
    loss: MTLoss,
    optimizer: Optimizer,
    with_forces: bool = True,
    precision: str = "fast",
    mesh=None,
):
    """Build ``step(state, batch, labels) -> (state, metrics)``.

    ``batch`` is one System (molecule bins or indexed) and ``labels`` a dict
    of tensors in its layout (``energy`` (num_mol,), ``forces`` (N, 3),
    ``charges`` (N,)).  ``precision``: ``"fast"`` (the default, TF32
    matmuls on the card) or ``"exact"`` (TF32 off); the tier's context
    wraps the forward and both derivatives.  ``metrics``: ``loss``, the
    loss's components and ``grad_norm`` (the trainable leaves' global norm
    before clipping), as 0-d tensors on the batch's device.

    ``mesh`` (``parallel.make_mesh``'s): every rank of the mesh calls the
    step with its own microbatch (the trainer's split); the gradient, the
    loss and its components are their means over the mesh's ranks (JAX's
    ``n_dev`` microbatches are this mesh's ``size``)."""
    ambient = ambient_for(precision)

    def step(state: TrainState, batch: System, labels: dict) -> tuple[TrainState, dict]:
        leaves = [leaf for _path, leaf in state.trainable]
        with ambient_matmul_context(ambient):
            pred = predict(state.params, cfg, batch, with_forces, create_graph=True)
            total, comps = loss(pred, labels, batch)
            grads = torch.autograd.grad(total, leaves, allow_unused=True)
        # a leaf the loss does not reach still takes Adam's step with a zero
        # gradient, as in optax (its moments decay)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
        scalars = {"loss": total.detach(), **{k: v.detach() for k, v in comps.items()}}
        if mesh is not None:
            grads, scalars = mean_over_mesh(mesh, grads, scalars)
        with torch.no_grad():
            norm = optimizer.apply(state.opt_state, leaves, grads)
        state.step += 1
        return state, {**scalars, "grad_norm": norm}

    return step
