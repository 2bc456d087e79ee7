"""Parametric terrain height field (counterpart of ``sim/terrain.py``):
z(x, y) = tan(pitch) clamp(x - slope_start, 0, slope_len)
        + step_height clamp(floor((x - stairs_start)+ / step_len), 0, n_steps).
Fields are per scenario (B,). Flat ground is pitch = 0, step_height = 0;
``Terrain.slope`` and ``Terrain.stairs`` give every scenario the JAX
package's slope or staircase (its defaults: the ``stairs_single`` world's
9 cm risers)."""

from __future__ import annotations

import torch

from a1_qp_mpc_controller_tpu_torch.tensors import (
    CUDA, resolve_device, tensorclass,
)


@tensorclass
class Terrain:
    pitch: torch.Tensor
    slope_start: torch.Tensor
    slope_len: torch.Tensor
    step_height: torch.Tensor
    step_len: torch.Tensor
    stairs_start: torch.Tensor
    n_steps: torch.Tensor

    @classmethod
    def flat(cls, batch: int, dtype=torch.float32, device=CUDA) -> "Terrain":
        device = resolve_device(device)
        z = lambda v=0.0: torch.full((batch,), v, dtype=dtype, device=device)
        return cls(pitch=z(), slope_start=z(), slope_len=z(),
                   step_height=z(), step_len=z(1.0), stairs_start=z(),
                   n_steps=z())

    @classmethod
    def slope(cls, batch: int, pitch_rad: float, start: float = 0.5,
              length: float = 10.0, dtype=torch.float32,
              device=CUDA) -> "Terrain":
        full = lambda v: torch.full((batch,), v, dtype=dtype,
                                    device=resolve_device(device))
        return cls.flat(batch, dtype, device).replace(
            pitch=full(pitch_rad), slope_start=full(start),
            slope_len=full(length))

    @classmethod
    def stairs(cls, batch: int, step_height: float = 0.09,
               step_len: float = 0.25, start: float = 0.5,
               n_steps: float = 8.0, dtype=torch.float32,
               device=CUDA) -> "Terrain":
        full = lambda v: torch.full((batch,), v, dtype=dtype,
                                    device=resolve_device(device))
        return cls.flat(batch, dtype, device).replace(
            step_height=full(step_height), step_len=full(step_len),
            stairs_start=full(start), n_steps=full(n_steps))


def height(t: Terrain, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Terrain height for points (B, ...) of scenario-batched terrain."""
    ex = lambda v: v.reshape(v.shape + (1,) * (x.ndim - v.ndim))
    run = torch.minimum(torch.clamp(x - ex(t.slope_start), min=0.0),
                        ex(t.slope_len))
    z_slope = torch.tan(ex(t.pitch)) * run
    tread = torch.floor(torch.clamp(x - ex(t.stairs_start), min=0.0)
                        / torch.clamp(ex(t.step_len), min=1e-6))
    tread = torch.minimum(torch.clamp(tread, min=0.0), ex(t.n_steps))
    return z_slope + ex(t.step_height) * tread + 0.0 * y
