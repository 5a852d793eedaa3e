"""Experiment trackers behind one small interface (counterpart of
aimnetcentral_tpu/train/trackers.py).

A tracker has ``log(record, step)`` and ``finish()``.  The JSONL backend
writes offline runs; the wandb backend needs the optional ``wandb`` package,
imported only when that tracker is built.
"""

from __future__ import annotations

import json
from typing import Any, Mapping

DEFAULT_PROJECT = "aimnet2-torch"


class JsonlTracker:
    """Append one JSON record per log call (the offline default)."""

    def __init__(self, path: str, config: Mapping[str, Any] | None = None):
        self.path = path
        if config:
            with open(path, "a") as f:
                f.write(json.dumps({"_config": dict(config)}) + "\n")

    def log(self, record: Mapping[str, Any], step: int | None = None) -> None:
        rec = dict(record)
        if step is not None:
            rec.setdefault("step", step)
        with open(self.path, "a") as f:
            f.write(json.dumps(rec) + "\n")

    def finish(self) -> None:
        pass


class WandbTracker:
    """wandb backend (requires the optional ``wandb`` package)."""

    def __init__(
        self,
        project: str = DEFAULT_PROJECT,
        run_name: str | None = None,
        config: Mapping[str, Any] | None = None,
    ):
        import wandb  # noqa: PLC0415 - optional extra

        self._run = wandb.init(project=project, name=run_name, config=dict(config or {}))

    def log(self, record: Mapping[str, Any], step: int | None = None) -> None:
        self._run.log(dict(record), step=step)

    def finish(self) -> None:
        self._run.finish()


def make_tracker(
    kind: str | None,
    *,
    path: str | None = None,
    project: str = DEFAULT_PROJECT,
    run_name: str | None = None,
    config: Mapping[str, Any] | None = None,
):
    """Build a tracker: ``None`` -> none, ``"jsonl"`` -> JsonlTracker,
    ``"wandb"`` -> WandbTracker (a RuntimeError if the extra is missing)."""
    if kind is None:
        return None
    if kind == "jsonl":
        if not path:
            raise ValueError("jsonl tracker requires a path")
        return JsonlTracker(path, config)
    if kind == "wandb":
        try:
            return WandbTracker(project=project, run_name=run_name, config=config)
        except ImportError as e:
            raise RuntimeError("tracker='wandb' requires the wandb package (pip install wandb)") from e
    raise ValueError(f"unknown tracker kind {kind!r}")
