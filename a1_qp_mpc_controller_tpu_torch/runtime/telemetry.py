"""Telemetry (counterpart of ``runtime/telemetry.py``): a rollout's
``Trace`` as a summary, JSON lines and an npz archive, with the JAX
package's keys, and ``device_trace``, a ``torch.profiler`` trace of the
host and the card around a block.

Every function takes a Trace with a leading tick axis, batched ((T, B,
...), as ``sim.closed_loop.rollout`` gives it) or not ((T, ...)); on an
unbatched one each gives what the JAX package's gives."""

from __future__ import annotations

import contextlib
import dataclasses
import json
from typing import IO, Iterator

import numpy as np

from a1_qp_mpc_controller_tpu_torch.runtime import profiling


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy()


def summarize_trace(trace) -> dict:
    """Headline statistics of a closed-loop Trace."""
    rp = _np(trace.root_pos)
    eu = _np(trace.root_euler_est)
    f = _np(trace.foot_forces_grf)
    return {
        "ticks": int(rp.shape[0]),
        "nan": bool(np.isnan(rp).any()),
        "final_pos": rp[-1].tolist(),
        "height_mean": float(rp[..., 2].mean()),
        "height_std": float(rp[..., 2].std()),
        "roll_max": float(np.abs(eu[..., 0]).max()),
        "pitch_max": float(np.abs(eu[..., 1]).max()),
        "fz_max": float(f[..., 2].max()),
        "fz_mean_total": float(f[..., 2].sum(-1).mean()),
        "speed_mean": float(_np(trace.root_lin_vel)[..., 0].mean()),
    }


def write_jsonl(trace, fp: IO[str], every: int = 1) -> int:
    """Write every ``every``-th tick as one JSON line (tick, position,
    roll-pitch-yaw, each foot's vertical force, contacts); returns the
    lines written."""
    rp = _np(trace.root_pos)
    eu = _np(trace.root_euler_est)
    f = _np(trace.foot_forces_grf)
    c = _np(trace.contacts)
    n = 0
    for t in range(0, rp.shape[0], every):
        fp.write(json.dumps({
            "t": t,
            "pos": np.round(rp[t], 5).tolist(),
            "rpy": np.round(eu[t], 5).tolist(),
            "fz": np.round(f[t, ..., 2], 2).tolist(),
            "contacts": c[t].astype(int).tolist(),
        }) + "\n")
        n += 1
    return n


def save_npz(trace, path: str) -> None:
    """Every field of the Trace, compressed, under its name."""
    np.savez_compressed(path, **{f.name: _np(getattr(trace, f.name))
                                 for f in dataclasses.fields(trace)})


@contextlib.contextmanager
def device_trace(logdir: str) -> Iterator[None]:
    """A ``torch.profiler`` trace of the host and the card around the
    block; the Chrome trace goes to ``logdir/trace.json``."""
    with profiling.trace(logdir):
        yield
