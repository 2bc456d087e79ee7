"""``python -m a1_qp_mpc_controller_tpu_torch`` (counterpart of
``__main__.py``) on the CPU, each command in a subprocess with one torch
thread:

- ``--cpu sim --seconds 0.05`` prints the JAX summary's keys;
- an unknown terrain, the time-source refusals of both kinds and the
  override (``tests/test_runtime.py``'s CLI tests on the port);
- ``--cpu sim --plant joint --seconds 0.05`` runs the articulated plant
  to the same summary;
- ``--cpu golden --seconds 0.1`` (shorter than the walk onset, so no
  sample) prints the JAX report's keys and fails its gate, exit 1;
- a command without ``--cpu`` where no card is visible exits non-zero with
  ``tensors.resolve_device``'s message and prints no result;
- ``joy_schedule``'s ``vely`` and ``yaw_rate``, restored for ``sim``,
  against the JAX function.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np

from a1_qp_mpc_controller_tpu.sim import closed_loop as jcl
from a1_qp_mpc_controller_tpu_torch.sim import closed_loop as tcl

from torch_parity import CPU, assert_tree_close

ROOT = Path(__file__).resolve().parent.parent
SUMMARY_KEYS = {"ticks", "nan", "final_pos", "height_mean", "height_std",
                "roll_max", "pitch_max", "fz_max", "fz_mean_total",
                "speed_mean"}
GATE_KEYS = {"samples", "max_dev_N", "mean_dev_N", "p95_dev_N",
             "frac_within_tol", "tol_N", "final_x_m", "final_z_m", "nan"}


def _env(hide_cards=False):
    env = dict(os.environ, OMP_NUM_THREADS="1")
    if hide_cards:
        env["CUDA_VISIBLE_DEVICES"] = ""
    return env


def _argv(args, cpu=True):
    return ([sys.executable, "-m", "a1_qp_mpc_controller_tpu_torch"]
            + (["--cpu"] if cpu else []) + list(args))


def _cli(*args, timeout=120):
    return subprocess.run(_argv(args), cwd=ROOT, env=_env(),
                          capture_output=True, text=True, timeout=timeout)


def test_sim_smoke():
    out = _cli("sim", "--seconds", "0.05", "--mpc-iters", "25",
               "--solver-mode", "fixed")
    assert out.returncode == 0, out.stderr[-2000:]
    rep = json.loads(out.stdout)
    assert rep.keys() == SUMMARY_KEYS
    assert rep["ticks"] == 20 and rep["nan"] is False
    assert 0.2 < rep["final_pos"][2] < 0.4


def test_bad_terrain_errors():
    out = _cli("sim", "--terrain", "volcano")
    assert out.returncode != 0
    assert "volcano" in out.stderr


def test_time_source_refusals_and_override():
    """Startup precondition parity (MainGazebo.cpp:31-37 /
    MainHardware.cpp:30-37): a simulated-time executor refuses a
    hardware profile and a wall-clock one a simulation profile; the
    override proceeds."""
    for args in (("sim", "--profile", "hardware_qp", "--seconds", "0.01"),
                 ("wire", "--profile", "gazebo_mpc", "--seconds", "0.01")):
        out = _cli(*args)
        assert out.returncode != 0, args
        assert "startup precondition" in out.stderr, args
    out = _cli("sim", "--profile", "hardware_qp", "--seconds", "0.05",
               "--mpc-iters", "25", "--solver-mode", "fixed",
               "--override-sim-time-check")
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout)["ticks"] == 20


def test_joint_plant_refused_by_name():
    """``sim --plant joint`` runs the articulated plant
    (``sim/joint_plant.py``) to the JAX summary's keys. (The name is kept
    from when the port refused the command.)"""
    out = _cli("sim", "--plant", "joint", "--seconds", "0.05",
               "--mpc-iters", "25", "--solver-mode", "fixed")
    assert out.returncode == 0, out.stderr[-2000:]
    rep = json.loads(out.stdout)
    assert rep.keys() == SUMMARY_KEYS
    assert rep["ticks"] == 20 and rep["nan"] is False
    assert 0.25 < rep["final_pos"][2] < 0.35
    assert rep["fz_mean_total"] > 0.0


def test_golden_without_a_sample_fails_its_gate():
    out = _cli("golden", "--seconds", "0.1", "--mpc-iters", "25",
               "--solver-mode", "fixed")
    assert out.returncode == 1, out.stderr[-2000:]
    rep = json.loads(out.stdout)
    assert rep.keys() == GATE_KEYS
    assert rep["samples"] == 0 and rep["frac_within_tol"] == 0.0
    assert rep["nan"] is False


def test_no_card_no_fallback():
    """Without ``--cpu`` every command asks for the card; with none
    visible it exits non-zero before any work, never on the CPU. The five
    commands run at once."""
    procs = {cmd: subprocess.Popen(
        _argv((cmd, "--seconds", "0.01"), cpu=False), cwd=ROOT,
        env=_env(hide_cards=True), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
        for cmd in ("sim", "realtime", "batch", "golden", "wire")}
    for cmd, proc in procs.items():
        stdout, stderr = proc.communicate(timeout=120)
        assert proc.returncode != 0, cmd
        assert "no CUDA device is available" in stderr, cmd
        assert not stdout, cmd


def test_joy_schedule_matches_jax():
    kw = dict(walk_after=3, velx=0.3, vely=-0.2, yaw_rate=0.5)
    assert_tree_close(tcl.joy_schedule(8, device=CPU, **kw),
                      jcl.joy_schedule(8, **kw), atol=0.0)
    joy = tcl.joy_schedule(8, device=CPU, **kw)
    np.testing.assert_array_equal(
        joy.vely.numpy(), np.float32([0.0] * 3 + [-0.2] * 5))
