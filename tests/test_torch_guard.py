"""The port stands alone: it imports neither JAX nor the JAX package,
and its entry points never fall back to the CPU on their own."""

import dataclasses
import pkgutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import a1_qp_mpc_controller_tpu_torch as port

ROOT = Path(__file__).resolve().parent.parent
PORT_DIR = Path(port.__file__).resolve().parent


def test_port_imports_no_jax():
    """Every module of the port, and chip_smoke.py with the modules it
    loads, imported in a fresh interpreter leave jax out of sys.modules."""
    mods = [m.name for m in pkgutil.walk_packages([str(PORT_DIR)],
                                                  prefix=port.__name__ + ".")]
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "import chip_smoke\n"
            "chip_smoke.Port()\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'a1_qp_mpc_controller_tpu'))\n"
            "assert not bad, bad\n"
            "print('NO_JAX_OK', len(sys.modules))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "NO_JAX_OK" in out.stdout
    assert len(mods) >= 25
    # the scan reaches the scripts' subpackage and the stand-QP modules
    for name in ("scripts.micro_admm", "scripts.probe_mosaic",
                 "scripts.probe_mosaic2", "scripts.probe_mosaic3",
                 "scripts.probe_mosaic4", "ops.kernels_scripts",
                 "ops.qp_ref", "control.safety", "runtime.golden",
                 "sim.closed_loop", "scripts.run_golden_dense",
                 "scripts.run_golden_amortized", "runtime.realtime",
                 "runtime.telemetry", "runtime.checkpoint",
                 "runtime.native", "runtime.wire", "runtime.sdk_wire",
                 "adapters.gazebo", "adapters.hardware", "adapters.isaac",
                 "adapters.joystick", "__main__", "entry",
                 "parallel.mesh", "sim.joint_plant", "models.calibration",
                 "scripts.multihost_worker"):
        assert f"{port.__name__}.{name}" in mods, name


@pytest.mark.parametrize("pattern", ["import jax", "from jax",
                                     "import flax", "from flax",
                                     "a1_qp_mpc_controller_tpu."])
def test_port_sources_name_no_jax(pattern):
    files = [ROOT / "chip_smoke.py"] + sorted(
        p for p in PORT_DIR.rglob("*")
        if p.suffix in (".py", ".cu", ".cuh", ".cc"))
    assert PORT_DIR / "native" / "rt_executor.cc" in files
    hits = [f"{p.relative_to(ROOT)}:{i}"
            for p in files
            for i, line in enumerate(p.read_text().splitlines(), 1)
            if pattern in line]
    assert not hits, hits


def test_entry_points_raise_without_a_card(monkeypatch):
    """With no card and no device="cpu", every entry point raises."""
    from a1_qp_mpc_controller_tpu_torch.adapters import hardware, joystick
    from a1_qp_mpc_controller_tpu_torch.config import load_profile
    from a1_qp_mpc_controller_tpu_torch.parallel import batched
    from a1_qp_mpc_controller_tpu_torch.runtime import (
        golden, realtime, sdk_wire, wire,
    )
    from a1_qp_mpc_controller_tpu_torch.scripts import (
        micro_admm, probe_mosaic, probe_mosaic3,
    )
    from a1_qp_mpc_controller_tpu_torch import entry
    from a1_qp_mpc_controller_tpu_torch.parallel import mesh
    from a1_qp_mpc_controller_tpu_torch.sim import closed_loop, joint_plant
    from a1_qp_mpc_controller_tpu_torch.sim import terrain
    from a1_qp_mpc_controller_tpu_torch.tensors import broadcast_batch
    from a1_qp_mpc_controller_tpu_torch.types import JoyCmd

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg, params = load_profile("gazebo_mpc", device="cpu")
    pb, terr, carry = batched.make_flat_batch(
        cfg, torch.Generator().manual_seed(0), 2, params, device="cpu")
    calls = [
        lambda: load_profile("gazebo_mpc"),
        lambda: batched.make_flat_batch(
            cfg, torch.Generator().manual_seed(0), 2, params),
        lambda: batched.randomize_params(torch.Generator(), 2, params),
        lambda: batched.make_kkt_carry(cfg, 2),
        lambda: JoyCmd.zeros(),
        lambda: batched.batched_closed_loop_step(
            dataclasses.replace(cfg, mpc_solver_mode="fixed"), pb, terr,
            carry, JoyCmd.zeros(device="cpu"), cfg.control_dt),
        lambda: batched.batched_closed_loop_step(
            dataclasses.replace(cfg, mpc_solver_mode="fixed"), pb, terr,
            carry, JoyCmd.zeros(device="cpu"), cfg.control_dt,
            kkt_backend="reduced_admm", rescue_capacity=1),
        lambda: closed_loop.joy_schedule(4),
        lambda: golden.run_stand_batched_gate(0.01),
        lambda: golden.run_gate(0.01),
        lambda: golden.run_amortized_gate(0.01, batch=2),
        lambda: golden.gate_params(params, 2),
        lambda: batched.flat_batch_from_params(cfg, pb),
        lambda: closed_loop.rollout(
            cfg, pb, terr, carry,
            closed_loop.joy_schedule(1, device="cpu"), 1),
        lambda: micro_admm.make_inputs(2),
        lambda: probe_mosaic.run_ladder(probe_mosaic.LADDER[:1]),
        lambda: probe_mosaic3.kkt_batch(2),
        lambda: terrain.Terrain.slope(2, 0.1),
        lambda: terrain.Terrain.stairs(2),
        lambda: batched.randomize_terrain(torch.Generator(), 2),
        lambda: batched.make_batch(cfg, torch.Generator(), 2, params),
        lambda: batched.batched_step(
            cfg, pb, terr, carry, JoyCmd.zeros(device="cpu"),
            cfg.control_dt),
        lambda: batched.batched_rollout(
            cfg, pb, terr, carry,
            closed_loop.joy_schedule(1, device="cpu"), 1),
        lambda: realtime.unpack_sensors(np.zeros(44, np.float32)),
        lambda: realtime.run_dual_rate_sim(
            cfg, broadcast_batch(params, 1),
            terrain.Terrain.flat(1, device="cpu"), 0.01,
            JoyCmd.zeros(device="cpu")),
        lambda: realtime.RealtimeRunner(),
        lambda: wire.MockA1Robot(broadcast_batch(params, 1),
                                 terrain.Terrain.flat(1, device="cpu")),
        lambda: wire.HardwareWireRunner(cfg, broadcast_batch(params, 1),
                                        ("127.0.0.1", 9)),
        lambda: wire.unpack_low_state(wire.pack_low_state(
            0, *(np.zeros(k, np.float32) for k in (4, 3, 3, 12, 12, 4)))),
        lambda: sdk_wire.unpack_low_state_sdk(sdk_wire.pack_low_state_sdk(
            0, np.array([1, 0, 0, 0], np.float32),
            *(np.zeros(k, np.float32) for k in (3, 3, 12, 12, 4)))),
        lambda: hardware.make_foot_force_filter(2),
        lambda: joystick.JoyState.init(),
        lambda: joint_plant.init_standing(pb, terr),
        lambda: closed_loop.make_standing_start(cfg, pb, terr,
                                                plant=joint_plant),
        lambda: batched.make_bench_state(cfg, torch.Generator(), 2, params),
        lambda: batched.bench_state_from_params(cfg, pb),
        lambda: mesh.multihost_init(),
        lambda: mesh.multihost_init("127.0.0.1:1", 1, 0),
        lambda: entry.entry(),
        lambda: entry.dryrun_cases(1, None),
        lambda: entry.dryrun_multichip(1),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
