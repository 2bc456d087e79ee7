"""The port stands alone: it imports neither JAX nor the JAX package,
and its entry points never fall back to the CPU on their own."""

import dataclasses
import pkgutil
import subprocess
import sys
from pathlib import Path

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


@pytest.mark.parametrize("pattern", ["import jax", "from jax",
                                     "import flax", "from flax",
                                     "a1_qp_mpc_controller_tpu."])
def test_port_sources_name_no_jax(pattern):
    files = [ROOT / "chip_smoke.py"] + sorted(
        p for p in PORT_DIR.rglob("*") if p.suffix in (".py", ".cu", ".cuh"))
    hits = [f"{p.relative_to(ROOT)}:{i}"
            for p in files
            for i, line in enumerate(p.read_text().splitlines(), 1)
            if pattern in line]
    assert not hits, hits


def test_entry_points_raise_without_a_card(monkeypatch):
    """With no card and no device="cpu", every entry point raises."""
    from a1_qp_mpc_controller_tpu_torch.config import load_profile
    from a1_qp_mpc_controller_tpu_torch.parallel import batched
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
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
