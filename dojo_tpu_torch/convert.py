"""Carry parameters and states across from dojo_tpu.

``params_from_numpy`` / ``state_from_numpy`` / ``gains_from_numpy`` take
dojo_tpu's Params / BodyState / TrotGains as dicts of numpy arrays, field by
field (``{f: np.asarray(getattr(p, f)) for f in p._fields}``), so both
packages can be fed the same mechanism and controller gains; nothing here
imports JAX or dojo_tpu.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .core import BodyState, Params, resolve_device
from .mpc.trot import TrotGains


def _build(cls, d, dtype, device):
    device = resolve_device(device)
    if dataclasses.is_dataclass(cls):
        names = [f.name for f in dataclasses.fields(cls)]
    else:  # a NamedTuple
        names = list(cls._fields)
    missing = set(names) - set(d)
    if missing:
        raise KeyError(f"{cls.__name__}: missing fields {sorted(missing)}")

    def t(a):
        a = np.array(a)  # a writable copy
        dt = dtype if dtype is not None and np.issubdtype(a.dtype, np.floating) else None
        return torch.as_tensor(a, dtype=dt, device=device)

    return cls(**{n: t(d[n]) for n in names})


def params_from_numpy(d, dtype=None, device=None) -> Params:
    """Params from a dict of numpy arrays (floats cast to ``dtype`` if given)."""
    return _build(Params, d, dtype, device)


def state_from_numpy(d, dtype=None, device=None) -> BodyState:
    """BodyState from a dict {x, q, v, w} of numpy arrays."""
    return _build(BodyState, d, dtype, device)


def gains_from_numpy(d, dtype=None, device=None) -> TrotGains:
    """TrotGains from a dict of numpy arrays (floats cast to ``dtype`` if
    given)."""
    return _build(TrotGains, d, dtype, device)


def to_numpy(obj) -> dict:
    """A dataclass of tensors as a dict of numpy arrays."""
    return {f.name: getattr(obj, f.name).detach().cpu().numpy() for f in dataclasses.fields(obj)}
