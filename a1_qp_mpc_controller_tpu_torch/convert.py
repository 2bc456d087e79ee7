"""State carried across from the JAX package: its pytrees given as nested
dicts of NumPy arrays (field name -> array or dict) become this package's
tensor dataclasses, and back. Used so that both packages can start a
comparison from identical state."""

from __future__ import annotations

import dataclasses
import typing

import numpy as np
import torch

from a1_qp_mpc_controller_tpu_torch.tensors import is_tensorclass

def _leaf(value, device, float64) -> torch.Tensor:
    arr = np.asarray(value)
    cast = {np.dtype(np.float64): float64, np.dtype(np.int64): torch.int32}
    return torch.tensor(arr, dtype=cast.get(arr.dtype), device=device)


def from_numpy(cls, tree: dict, device, float64=torch.float32):
    """Build ``cls`` (a tensor dataclass) from a nested dict of arrays;
    float64 arrives as ``float64`` (float32 unless asked: a float64
    comparison passes ``torch.float64``) and int64 as int32. Missing
    optional fields (``None`` in the dict) stay ``None``."""
    hints = typing.get_type_hints(cls)
    kwargs = {}
    for f in dataclasses.fields(cls):
        value = tree[f.name]
        hint = hints[f.name]
        if isinstance(value, dict):
            kwargs[f.name] = from_numpy(hint, value, device, float64)
        elif value is None:
            kwargs[f.name] = None
        else:
            kwargs[f.name] = _leaf(value, device, float64)
    return cls(**kwargs)


def to_numpy(obj):
    """Tensor dataclass -> nested dict of NumPy arrays (tensor -> array)."""
    if is_tensorclass(obj):
        return {f.name: to_numpy(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    if obj is None:
        return None
    return obj.detach().cpu().numpy()
