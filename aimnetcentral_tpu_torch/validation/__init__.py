"""Numerics validation across versions and devices: the observables dump
and its comparer."""

from aimnetcentral_tpu_torch.validation.observables import (  # noqa: F401
    compare_observables,
    dump_observables,
    reference_systems,
)
