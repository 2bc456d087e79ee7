"""Checkpoint and resume of controller and simulation state (counterpart
of ``runtime/checkpoint.py``): a tree of the port's tensor dataclasses
(a ``LoopCarry``, params, a ``KktCarry``, ...) written as one npz
archive, one array a leaf under its field path (``cs/root_pos``), and
restored bit for bit into the structure, device and dtypes of a like
tree. The leaves go through ``convert.to_numpy`` / ``from_numpy``, which
keeps float32, int32 and bool (the port's state has no 64-bit leaf)."""

from __future__ import annotations

from typing import Any

import numpy as np

from a1_qp_mpc_controller_tpu_torch import convert
from a1_qp_mpc_controller_tpu_torch.tensors import tree_map


def _flat(tree: dict, prefix: str = "") -> dict:
    out = {}
    for name, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{name}/"))
        elif v is not None:
            out[f"{prefix}{name}"] = v
    return out


def save(path: str, tree: Any) -> None:
    np.savez_compressed(path, **_flat(convert.to_numpy(tree)))


def load(path: str, like: Any) -> Any:
    """Restore into the structure of ``like`` on its device; each leaf's
    shape and dtype must match ``like``'s."""
    data = np.load(path)
    ref = _flat(convert.to_numpy(like))
    if set(data.files) != set(ref):
        raise ValueError(f"checkpoint fields {sorted(data.files)} != "
                         f"{sorted(ref)}")
    for key, arr in ref.items():
        got = data[key]
        if (got.shape, got.dtype) != (arr.shape, arr.dtype):
            raise ValueError(f"checkpoint leaf {key}: {got.shape} "
                             f"{got.dtype} != {arr.shape} {arr.dtype}")

    def tree(obj, prefix=""):
        return {name: (tree(v, f"{prefix}{name}/") if isinstance(v, dict)
                       else None if v is None else data[f"{prefix}{name}"])
                for name, v in obj.items()}

    leaves = []
    tree_map(leaves.append, like)
    return convert.from_numpy(type(like), tree(convert.to_numpy(like)),
                              leaves[0].device)


def roundtrip_equal(a: Any, b: Any) -> bool:
    """Whether two trees hold the same leaves, bit for bit."""
    fa, fb = _flat(convert.to_numpy(a)), _flat(convert.to_numpy(b))
    return fa.keys() == fb.keys() and all(
        np.array_equal(fa[k], fb[k]) for k in fa)
