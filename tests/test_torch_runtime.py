"""The port's real-time runtime (``runtime/native.py`` over its own copy
of ``native/rt_executor.cc``, ``runtime/realtime.py:RealtimeRunner``) on
the CPU:

- the mirror of ``tests/test_runtime.py``'s ring, loop and overrun
  tests, on the port's own build;
- a raising callback fails ``RtLoop.stop()`` and ``RealtimeRunner.run``
  with its first exception, and no native thread is left running;
- the tick and estimate functions the runner's two threads share state
  through write into none of their inputs (every input cloned, each
  function run once from ``torch_parity.stood_start`` at B = 1 on the
  trot command, the inputs compared bit for bit);
- the runner in both schedules (sim parity, and the EKF at the 500 Hz
  sensor rate), in a subprocess on the CPU for 0.4 s, with the asserts of
  ``tests/test_runtime.py``'s smoke;
- the telemetry stream: ``ticks // every`` records, ``ticks`` the
  runner's own count, each with the JAX runner's keys. (The JAX test
  asserts at least 3 records in 0.3 s of wall clock, which its runner
  does not always reach; ROADMAP §3.)
"""

import dataclasses
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from a1_qp_mpc_controller_tpu_torch.control import controller as tctl
from a1_qp_mpc_controller_tpu_torch.runtime import native
from a1_qp_mpc_controller_tpu_torch.runtime.native import RtLoop, SensorRing
from a1_qp_mpc_controller_tpu_torch.runtime.realtime import RealtimeRunner
from a1_qp_mpc_controller_tpu_torch.sim import plant as tplant

from torch_parity import CPU, stood_start

ROOT = Path(__file__).resolve().parent.parent
STAT_KEYS = {"iterations", "missed_deadlines", "last_work_ms",
             "max_work_ms", "mean_work_ms", "max_jitter_ms",
             "mean_jitter_ms", "solve_p50_ms", "solve_p99_ms",
             "ring_dropped", "root_pos"}
TELEMETRY_KEYS = {"tick", "t_s", "root_pos", "root_pos_d", "root_euler",
                  "root_euler_d", "root_lin_vel", "contacts",
                  "foot_forces_grf", "joint_torques", "terrain_pitch"}


def _threads() -> int:
    return len(os.listdir("/proc/self/task"))


def test_library_builds_under_build():
    lib = native.build()
    assert lib.name == "librt_executor.so"
    assert lib.parent.parent == ROOT / "build" / "native"


def test_sensor_ring_latest_wins():
    r = SensorRing(4)
    assert r.pop_latest() is None
    for i in range(10):
        r.push(np.full(4, float(i), np.float32))
    np.testing.assert_allclose(r.pop_latest(), 9.0)
    assert r.pop_latest() is None  # drained
    with pytest.raises(ValueError, match="ring takes 4"):
        r.push(np.zeros(5, np.float32))


def test_sensor_ring_overwrite_drops_oldest():
    r = SensorRing(2, capacity_pow2=2)  # 4 slots
    for i in range(10):
        r.push(np.full(2, float(i), np.float32))
    assert r.dropped > 0
    np.testing.assert_allclose(r.pop_latest(), 9.0)


def test_rt_loop_rate_and_stats():
    # wall-clock jitter depends on the machine's load: the best of 3
    last = None
    for _ in range(3):
        count = [0]

        def work(_tick):
            count[0] += 1

        loop = RtLoop(0.005, work, compensate=True)
        loop.start()
        time.sleep(0.25)
        loop.stop()
        s = loop.stats()
        assert s["iterations"] == count[0]
        last = s
        if (30 <= s["iterations"] <= 60 and s["missed_deadlines"] == 0
                and s["mean_jitter_ms"] < 1.0):
            return
    assert 30 <= last["iterations"] <= 60
    assert last["missed_deadlines"] == 0
    assert last["mean_jitter_ms"] < 1.0


def test_rt_loop_overrun_accounting():
    def slow(_tick):
        time.sleep(0.01)  # 10 ms work in a 5 ms loop

    loop = RtLoop(0.005, slow, compensate=True)
    loop.start()
    time.sleep(0.2)
    loop.stop()
    s = loop.stats()
    assert s["missed_deadlines"] == s["iterations"] > 0


def test_raising_callback_fails_stop_with_the_first_exception():
    calls = []

    def fails(tick):
        calls.append(tick)
        if tick >= 2:
            raise ValueError(f"tick {tick}")

    before = _threads()
    loop = RtLoop(0.002, fails, compensate=False)
    loop.start()
    deadline = time.monotonic() + 10.0     # a loaded host is slow
    while ((loop.error is None or loop.stats()["iterations"] <= 3)
           and time.monotonic() < deadline):
        time.sleep(0.005)
    with pytest.raises(ValueError, match="tick 2"):
        loop.stop()
    assert calls == [0, 1, 2]          # not called again once it raised
    n = loop.stats()["iterations"]
    assert n > 3                        # the schedule ran on, idle
    time.sleep(0.02)
    assert loop.stats()["iterations"] == n   # joined
    assert _threads() == before


@pytest.mark.parametrize("schedule", ["sim", "sensor_rate_ekf"])
def test_runner_fails_with_the_first_exception(schedule):
    """A control-loop callback that raises on its second tick (then on
    every later one, were it called) fails ``run`` with its first
    exception, both loops joined."""
    runner = RealtimeRunner(mpc_iters=5, solver_mode="fixed",
                            estimation_rate_hz=(
                                500.0 if schedule != "sim" else None),
                            device=CPU)
    seen = []

    def fails(tick):
        seen.append(tick)
        if len(seen) >= 2:
            raise RuntimeError(f"control tick {len(seen)}")

    runner.run(0.05)    # a first run: every lazily started thread is up
    name = "_consume" if schedule == "sim" else "_consume_noest"
    setattr(runner, name, fails)
    before = _threads()
    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match="control tick 2$"):
        runner.run(5.0)
    elapsed = time.perf_counter() - t0
    assert elapsed < 2.5, elapsed          # ended at the failure
    assert len(seen) == 2
    assert _threads() == before, (before, _threads())


def _leaves(obj):
    if torch.is_tensor(obj):
        return [obj]
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return [leaf for f in dataclasses.fields(obj)
                for leaf in _leaves(getattr(obj, f.name))]
    return []


def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def test_tick_functions_write_into_no_input():
    start = stood_start(1, dict(rescue_capacity=1, rescue_iters=150))
    cfg, params = start["tcfg"], start["tpb"]
    carry, joy = start["tcarry"], start["tjoy"]
    dt, s_dt = torch.tensor(cfg.control_dt), torch.tensor(0.002)

    def unchanged(fn, *args):
        ins = [leaf for a in args for leaf in _leaves(a)]
        copies = [leaf.clone() for leaf in ins]
        out = fn(*args)
        changed = [i for i, (a, b) in enumerate(zip(ins, copies))
                   if not torch.equal(_bits(a), _bits(b))]
        assert not changed, (fn.__name__, changed)
        return out

    sensors = unchanged(tplant.read_sensors, params, carry.ps,
                        carry.prev_root_lin_vel, dt)
    cs, mem, tq = unchanged(tctl.control_tick, cfg, params, carry.cs,
                            carry.mem, sensors, joy, dt)
    assert tq.abs().max() > 1.0
    unchanged(tplant.plant_step, params, start["tterr"], carry.ps, tq, dt)
    cs_e, mem_e = unchanged(tctl.estimate_step, cfg, params, cs, mem,
                            sensors, s_dt)
    cs_m = unchanged(tctl.merge_estimate_cs, cs_e, cs)
    mem_m = unchanged(tctl.merge_estimate_mem, mem_e, mem)
    unchanged(tctl.control_tick_noest, cfg, params, cs_m, mem_m, joy, dt)


def test_runner_smoke_both_schedules():
    """``tests/test_runtime.py``'s smoke in both schedules, in a
    subprocess (the runner's native threads live there)."""
    code = (
        "import json, numpy as np, torch\n"
        "torch.set_num_threads(1)\n"
        "from a1_qp_mpc_controller_tpu_torch.runtime.realtime import "
        "RealtimeRunner\n"
        "for rate in (None, 500.0):\n"
        "    r = RealtimeRunner(mpc_iters=25, solver_mode='fixed', "
        "estimation_rate_hz=rate, device='cpu')\n"
        "    s = r.run(0.4)\n"
        "    assert s['iterations'] > 0, s\n"
        "    assert not np.isnan(np.asarray(s['root_pos'])).any(), s\n"
        "    assert 0.1 < s['root_pos'][2] < 0.5, s\n"
        "    print(json.dumps(s))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    for line in out.stdout.splitlines():
        s = json.loads(line)
        assert STAT_KEYS <= s.keys()
        assert s["ticks"] > 0 and s["solve_p50_ms"] > 0


def test_telemetry_stream(tmp_path):
    path = tmp_path / "live.jsonl"
    every = 2
    with RealtimeRunner(mpc_iters=5, solver_mode="fixed",
                        telemetry_jsonl=str(path), telemetry_every=every,
                        device=CPU) as r:
        # runs append to one stream and count ticks across runs: run
        # until a few records are due, however loaded the host
        deadline = time.monotonic() + 60.0
        while r.ticks < 3 * every and time.monotonic() < deadline:
            s = r.run(0.3)
    lines = path.read_text().splitlines()
    assert s["ticks"] == r.ticks >= 3 * every
    assert len(lines) == r.ticks // every
    for k, line in enumerate(lines, 1):
        rec = json.loads(line)
        assert rec.keys() == TELEMETRY_KEYS
        assert rec["tick"] == k * every
        assert len(rec["root_pos"]) == 3 and len(rec["contacts"]) == 4
        assert np.shape(rec["foot_forces_grf"]) == (4, 3)
        assert len(rec["joint_torques"]) == 12
