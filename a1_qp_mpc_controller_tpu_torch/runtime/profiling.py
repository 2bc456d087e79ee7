"""Timing on the card (counterpart of ``runtime/profiling.py``).

:func:`time_scan` times ``repeats`` dependent calls of a step between two
CUDA events on the current stream, so the time is the card's, not the
host's enqueue. :func:`trace` records a ``torch.profiler`` trace of the
host and the card around a block. Both need a CUDA card: a CPU run
gives no device time.
"""

from __future__ import annotations

import contextlib
import os
from typing import Any, Callable, Optional

import torch


def time_scan(step: Callable[[Any], Any], init: Any, *, repeats: int = 10,
              reps: int = 3, name: Optional[str] = None,
              printer=print) -> float:
    """Best-of-``reps`` seconds per call of ``step`` (carry -> carry),
    each rep ``repeats`` calls from ``init`` between two CUDA events,
    after one warm-up call."""
    if not torch.cuda.is_available():
        raise RuntimeError("time_scan times on a CUDA card; none is "
                           "available")
    step(init)
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        carry = init
        start.record()
        for _ in range(repeats):
            carry = step(carry)
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / 1e3)
    per_iter = best / repeats
    if name is not None:
        printer(f"{name:44s} {per_iter * 1e3:9.3f} ms/iter")
    return per_iter


@contextlib.contextmanager
def trace(logdir: str):
    """Record the host's and the card's activity around a block; the
    Chrome trace goes to ``logdir/trace.json``."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(logdir, exist_ok=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
