"""The scenario mesh over ``torch.distributed`` (``parallel/mesh.py``), its
callers and ``make_bench_state``, on the CPU (gloo):

- ``parallel/batched.make_bench_state``'s deterministic part
  (``bench_state_from_params``) against the JAX ``make_bench_state`` on
  the JAX draws carried across;
- ``multihost_init`` (no launcher: nothing to do; explicit arguments: a
  group, or an error), ``batch`` and ``entry.main`` binding the rank's
  device before they make a tensor, the mesh helpers and
  ``entry.dryrun_multichip(1)``
  on a process group of one rank, each case bit-equal to the same route
  run without the mesh;
- the port's worker (``scripts/multihost_worker.py``) as 4 gloo processes
  forming a (2, 2) host x scenario mesh, to ``tests/test_distributed.py``'s
  assertions, its reduced values equal to one process running each rank's
  block in turn and reducing here;
- ``batch`` under ``torchrun`` with two ranks: one JSON, from rank 0,
  equal to the one-process run's (the global mean, p95 and alive share).
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from a1_qp_mpc_controller_tpu.config import load_profile as jload
from a1_qp_mpc_controller_tpu.parallel import batched as jb
from a1_qp_mpc_controller_tpu_torch import entry
from a1_qp_mpc_controller_tpu_torch.config import RobotParams
from a1_qp_mpc_controller_tpu_torch.config import load_profile as tload
from a1_qp_mpc_controller_tpu_torch.parallel import batched as tb
from a1_qp_mpc_controller_tpu_torch.parallel import mesh as meshmod
from a1_qp_mpc_controller_tpu_torch.scripts import multihost_worker
from a1_qp_mpc_controller_tpu_torch.tensors import tree_map

from torch_parity import CPU, assert_tree_close, bench_state, to_port

ROOT = Path(__file__).resolve().parent.parent
PKG = "a1_qp_mpc_controller_tpu_torch"


def _env():
    return dict(os.environ, OMP_NUM_THREADS="1")


def test_bench_state_matches_jax():
    """Four scenarios of ``PRNGKey(0)``'s draws: the params carried
    across, the standing state, the sensors and the memory with its tick
    past the warmup shield."""
    from a1_qp_mpc_controller_tpu_torch.types import (
        CtrlMem, CtrlState, SensorData,
    )
    cfg, params = jload("gazebo_mpc")
    tcfg, _ = tload("gazebo_mpc", device=CPU)
    draws = jax.jit(lambda k: jb.randomize_params(k, 4, params))(
        jax.random.PRNGKey(0))
    ref = bench_state(cfg, 0, 4, params)
    pt = to_port(RobotParams, draws)
    out = tb.bench_state_from_params(tcfg, pt, device=CPU)
    for port, jax_obj in zip(out[1:], ref[1:]):
        assert_tree_close(port, jax_obj, atol=1e-5, scale_tol=1e-5)
    assert (out[2].tick == cfg.torque_warmup_ticks).all()
    assert isinstance(out[1], CtrlState) and isinstance(out[2], CtrlMem)
    assert isinstance(out[3], SensorData)
    # the generator's entry point: the same function of its own draws
    gen = tb.make_bench_state(tcfg, torch.Generator().manual_seed(0), 4,
                              tload("gazebo_mpc", device=CPU)[1], device=CPU)
    assert gen[3].joint_pos.shape == (4, 12)


def test_multihost_init_without_a_launcher_does_nothing(monkeypatch):
    for var in ("RANK", "WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    assert meshmod.multihost_init(device="cpu") is None
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="num_processes"):
        meshmod.multihost_init("127.0.0.1:1", device="cpu")


@pytest.fixture
def one_rank():
    meshmod.multihost_init(meshmod.local_coordinator(), 1, 0, device="cpu")
    try:
        yield meshmod.make_mesh()
    finally:
        dist.destroy_process_group()


def test_mesh_helpers_on_one_rank(one_rank):
    mesh = one_rank
    assert dist.get_backend() == "gloo"
    assert mesh.mesh_dim_names == ("scenario",)
    assert meshmod.block(mesh) == (0, 1)
    x = torch.arange(12.0).reshape(6, 2)
    assert torch.equal(meshmod.shard_batch(x, mesh), x)
    assert torch.equal(meshmod.take_block(x, 1, 3), x[2:4])
    with pytest.raises(ValueError, match="does not split"):
        meshmod.take_block(x, 0, 4)
    assert float(meshmod.mean(x, mesh)) == float(x.mean())
    assert float(meshmod.amax(x, mesh)) == 11.0
    assert torch.equal(meshmod.gather(x, mesh), x)


@pytest.mark.parametrize("command", ["batch", "entry"])
def test_rank_binds_its_device_before_any_tensor(monkeypatch, capsys,
                                                 command):
    """Under a launcher (one rank here), ``batch`` and ``entry.main``
    join the group and bind the rank's device before the profile's
    tensors are made, and make them on the device ``multihost_init``
    returned: a rank that made its constants before the bind would hold
    them on another card than its batch."""
    from a1_qp_mpc_controller_tpu_torch import __main__ as cli
    from a1_qp_mpc_controller_tpu_torch import config

    calls = []
    bind, load = meshmod._bind, config.load_profile

    def record_bind(device, local_rank):
        calls.append(("bind", local_rank))
        return bind(device, local_rank)

    def record_load(*args, device, **kw):
        calls.append(("load_profile", torch.device(device)))
        return load(*args, device=device, **kw)

    monkeypatch.setattr(meshmod, "_bind", record_bind)
    monkeypatch.setattr(config, "load_profile", record_load)
    port = meshmod.local_coordinator().rsplit(":", 1)[1]
    for var, value in dict(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
                           LOCAL_WORLD_SIZE="1", MASTER_ADDR="127.0.0.1",
                           MASTER_PORT=port).items():
        monkeypatch.setenv(var, value)
    if command == "batch":
        cli.main(["--cpu", "batch", "--n", "2", "--steps", "4",
                  "--mpc-iters", "10"])
        assert json.loads(capsys.readouterr().out)["alive_frac"] == 1.0
    else:
        entry.main(["--cpu"])
        assert "dryrun_multichip ok" in capsys.readouterr().out
    assert not dist.is_initialized()
    assert calls[0] == ("bind", 0), calls
    assert len(calls) > 1 and all(
        c == ("load_profile", CPU) for c in calls[1:]), calls


def test_dryrun_multichip_on_one_rank(one_rank):
    """Each case's per-scenario results bit-equal to the same route
    called without the mesh on the same batch."""
    out = entry.dryrun_multichip(1, device="cpu")
    ref = entry.dryrun_cases(1, None, device="cpu")
    for key in ("err", "carry_step", "carry_reduced", "carry_amortized",
                "kkt_carry"):
        a, b = [], []
        tree_map(lambda x, y: (a.append(x), b.append(y)), out[key],
                 ref[key])
        assert all(torch.equal(x, y) for x, y in zip(a, b)), key
    assert out["carry_amortized"].ps.root_pos.shape == (entry.PER_RANK, 3)


def test_four_process_worker_on_a_host_chip_mesh():
    """4 gloo processes as 2 hosts x 2 ranks: every rank prints the same
    reduced values, and they equal one process's run of each block in
    turn, reduced here."""
    port = meshmod.local_coordinator().rsplit(":", 1)[1]
    procs = [subprocess.Popen(
        [sys.executable, "-m", f"{PKG}.scripts.multihost_worker", str(i),
         "4", port, "--local-ranks", "2", "--cpu"], cwd=ROOT, env=_env(),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for i in range(4)]
    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(timeout=300)[0])
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {i} failed:\n{out[-3000:]}"
        assert "MULTIHOST_OK" in out, out[-3000:]
        assert ("processes=4 backend=gloo mesh=(2, 2) axes=host,scenario"
                in out), out[-3000:]
        assert "production-route mean|tau|=" in out, out[-3000:]
        assert "amortized-route mean|tau|=" in out, out[-3000:]
    vals = [out.split("MULTIHOST_OK")[1].split()[:3] for out in outs]
    assert all(v == vals[0] for v in vals), vals
    blocks = [multihost_worker.block_torques(i, 4, CPU) for i in range(4)]
    for k, name in enumerate(("xla", "production", "amortized")):
        tau = torch.cat([b[name] for b in blocks]).abs().double()
        np.testing.assert_allclose(float(vals[0][k]), float(tau.mean()),
                                   rtol=1e-6, atol=1e-6)


def test_batch_over_two_ranks_matches_one():
    args = ["--cpu", "batch", "--n", "4", "--steps", "8", "--mpc-iters",
            "10"]
    two = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", PKG, *args], cwd=ROOT, env=_env(),
        capture_output=True, text=True, timeout=300)
    one = subprocess.run([sys.executable, "-m", PKG, *args], cwd=ROOT,
                         env=_env(), capture_output=True, text=True,
                         timeout=300)
    assert two.returncode == 0, two.stderr[-3000:]
    assert one.returncode == 0, one.stderr[-3000:]
    assert two.stdout.count("mean_height_err") == 1, two.stdout
    got, want = json.loads(two.stdout), json.loads(one.stdout)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, err_msg=k)
    assert got["alive_frac"] == 1.0
