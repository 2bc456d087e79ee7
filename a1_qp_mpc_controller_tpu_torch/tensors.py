"""Tensor dataclasses, a tree map over them, and device resolution.

State types are frozen dataclasses whose leaves are tensors with a
leading batch dimension (the port writes out the batch axis that the
JAX package gets from ``vmap``). :func:`tree_map` walks them the way
``jax.tree_util.tree_map`` walks a pytree.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable

import torch

CUDA = torch.device("cuda")


def tensorclass(cls):
    """Frozen dataclass with a ``replace`` method (the flax
    ``struct.PyTreeNode`` counterpart). Equality is identity: comparing
    tensors field by field is never what a caller means."""
    cls = dataclasses.dataclass(frozen=True, eq=False)(cls)
    cls.replace = lambda self, **kw: dataclasses.replace(self, **kw)
    return cls


def const(values, dtype, device) -> torch.Tensor:
    """A small constant tensor, made once per (values, dtype, device) and
    shared by every call: building it from a Python list on each call is
    a synchronizing host-to-device copy each time. Never write into it."""
    return _const(_frozen(values), dtype, torch.device(device))


def _frozen(values):
    if isinstance(values, (list, tuple)):
        return tuple(_frozen(v) for v in values)
    return float(values) if isinstance(values, float) else values


@functools.lru_cache(maxsize=256)
def _const(values, dtype, device) -> torch.Tensor:
    return torch.tensor(values, dtype=dtype, device=device)


def is_tensorclass(obj: Any) -> bool:
    return dataclasses.is_dataclass(obj) and not isinstance(obj, type)


def tree_map(fn: Callable, *trees):
    """Apply ``fn`` leafwise over one or more structurally equal trees of
    tensor dataclasses; ``None`` leaves stay ``None``."""
    t0 = trees[0]
    if is_tensorclass(t0):
        return type(t0)(**{
            f.name: tree_map(fn, *(getattr(t, f.name) for t in trees))
            for f in dataclasses.fields(t0)})
    if t0 is None:
        return None
    return fn(*trees)


def resolve_device(device) -> torch.device:
    """The device an entry point runs on. A CUDA device without a card
    raises: an entry point never falls back to the CPU unless the caller
    asks for it."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port's plain PyTorch path on the CPU")
    return device


host_syncs = 0


def host_bool(flag: torch.Tensor) -> bool:
    """Read a device boolean on the host: the port's counterpart of a
    ``lax.cond`` predicate. Each read is one host sync, counted in
    ``host_syncs``."""
    global host_syncs
    host_syncs += 1
    return bool(flag)


def host_flag_and_indices(flag: torch.Tensor, mask: torch.Tensor
                          ) -> tuple[bool, torch.Tensor]:
    """Read a device boolean and the indices of a device boolean
    vector's True entries in one copy to the host: one host sync,
    counted in ``host_syncs``. The indices go back to ``mask``'s
    device."""
    global host_syncs
    host_syncs += 1
    both = torch.cat([flag.reshape(1), mask]).cpu()
    return (bool(both[0]),
            torch.nonzero(both[1:]).squeeze(1).to(mask.device))


def top_k_indices(score: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the ``k`` largest scores with ties to the lower index,
    the order ``jax.lax.top_k`` gives (``torch.topk`` promises none).
    The indices come from a sort of ``score`` itself, so every gather by
    them is in range (``jnp.take`` would clamp, torch indexing would
    fail); ``k`` is checked here, on the host."""
    if not 0 < k <= score.shape[0]:
        raise ValueError(f"top {k} of {score.shape[0]} scores")
    return torch.sort(score, descending=True, stable=True).indices[:k]


def check_on(device, *tensors) -> torch.device:
    """Resolve ``device`` and require every tensor to lie on it."""
    device = resolve_device(device)
    for t in tensors:
        if t.device.type != device.type:
            raise ValueError(f"tensor on {t.device}, entry point asked "
                             f"for {device}")
    return device


def where_b(mask: torch.Tensor, a: torch.Tensor, b: torch.Tensor):
    """``torch.where`` with a leading-dims mask broadcast over the
    trailing dims of ``a``/``b`` (the per-scenario select that ``vmap``
    gives the JAX package for free)."""
    m = mask.reshape(mask.shape + (1,) * (a.ndim - mask.ndim))
    return torch.where(m, a, b)


def select_tree(mask: torch.Tensor, a, b):
    """Per-scenario select between two state trees."""
    return tree_map(lambda x, y: where_b(mask, x, y), a, b)


def broadcast_batch(tree, n: int):
    """Tile an unbatched tree to a leading batch of ``n`` (contiguous
    copies, so later in-place scatters never alias)."""
    return tree_map(lambda a: a.expand((n,) + a.shape).clone(), tree)
