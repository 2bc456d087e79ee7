"""Entry points (counterpart of ``__graft_entry__.py``).

``entry()``              -> (fn, example_args): the single-scenario
                            control tick (the flagship path), a batch of
                            one.
``dryrun_multichip(n)``  -> on the scenario mesh over the n ranks of the
                            initialized process group, one batched
                            control and plant step of 2 scenarios a rank
                            on three routes (:func:`dryrun_cases`).

    python -m a1_qp_mpc_controller_tpu_torch.entry [--cpu]

runs both, over a launcher's ranks (``torchrun``) or, started plainly,
over a process group of one rank.
"""

from __future__ import annotations

import argparse
import dataclasses

import torch
import torch.distributed as dist

from a1_qp_mpc_controller_tpu_torch.tensors import (
    CUDA, broadcast_batch, const, resolve_device,
)

PER_RANK = 2      # scenarios a rank in the dry run


def _flagship_cfg(device):
    from a1_qp_mpc_controller_tpu_torch.config import load_profile
    cfg, params = load_profile("gazebo_mpc", device=device)
    # lock-step fixed-iteration MPC solver: deterministic work a tick
    return dataclasses.replace(cfg, mpc_qp_iters=50,
                               mpc_solver_mode="fixed"), params


def entry(device=CUDA):
    """One full control tick (sensors -> ingest -> FSM -> gait -> swing ->
    EKF -> MPC QP -> torques) of one scenario from the all-zero sensors:
    returns (fn, args), ``fn(*args)`` giving (cs, mem, torques)."""
    from a1_qp_mpc_controller_tpu_torch.control.controller import (
        control_tick,
    )
    from a1_qp_mpc_controller_tpu_torch.types import (
        CtrlMem, CtrlState, JoyCmd, SensorData,
    )

    device = resolve_device(device)
    cfg, params = _flagship_cfg(device)
    params = broadcast_batch(params, 1)
    z = lambda k: torch.zeros((1, k), device=device)
    sensors = SensorData(
        root_quat=torch.tensor([[1.0, 0.0, 0.0, 0.0]], device=device),
        root_pos=z(3), root_lin_vel=z(3), imu_acc=z(3), imu_ang_vel=z(3),
        joint_pos=z(12), joint_vel=z(12), foot_force=z(4))
    args = (params, CtrlState.init(cfg, params, device=device),
            CtrlMem.init(cfg, params, device=device), sensors,
            JoyCmd.zeros(device=device),
            const(cfg.control_dt, torch.float32, device))

    def fn(params, cs, mem, sensors, joy, dt):
        return control_tick(cfg, params, cs, mem, sensors, joy, dt)

    return fn, args


def dryrun_cases(n_ranks: int, mesh, device=CUDA) -> dict:
    """The dry run's three cases on this rank's block of the global batch
    of ``PER_RANK * n_ranks`` scenarios (``mesh=None``: the whole batch,
    no mesh):

    1. ``batched_step`` (``control_tick`` and the plant, the vmapped tick
       of the JAX package) of ``make_batch``'s randomized terrain batch,
       its height error averaged over the mesh;
    2. the production route, ``batched_closed_loop_step`` on
       'pallas_shared' / 'reduced_admm' at ``kkt_reduced_nr=64`` and
       8 iterations (K3 on the reduced tier, K1 on the full size, K2), of
       ``make_flat_batch``'s walking start, pools sized per shard;
    3. the 'amortized' route from case 2's state with its per-shard
       ``KktCarry`` (K1 on the refresh, K2).

    Returns each case's per-scenario results: ``err`` and ``carry_step``
    (case 1), ``carry_reduced`` (2), ``carry_amortized`` and
    ``kkt_carry`` (3), and ``mean_err``."""
    from a1_qp_mpc_controller_tpu_torch.parallel import batched
    from a1_qp_mpc_controller_tpu_torch.parallel import mesh as meshmod
    from a1_qp_mpc_controller_tpu_torch.types import JoyCmd

    device = resolve_device(device)
    cfg, base = _flagship_cfg(device)
    n = PER_RANK * n_ranks
    shard = lambda trees: tuple(meshmod.shard_batch(t, mesh) for t in trees)
    dt = const(cfg.control_dt, torch.float32, device)
    joy = JoyCmd.zeros(device=device)

    params, terrain, carry = shard(batched.make_batch(
        cfg, torch.Generator().manual_seed(0), n, base, device=device))
    carry, err = batched.batched_step(cfg, params, terrain, carry, joy, dt,
                                      substeps=2, device=device)
    mean_err = meshmod.mean(err, mesh)

    cfg_p = dataclasses.replace(cfg, mpc_qp_iters=8)
    params2, terrain2, carry2 = shard(batched.make_flat_batch(
        cfg_p, torch.Generator().manual_seed(1), n, base, device=device))
    joy_w = joy.replace(ctrl_state=torch.ones_like(joy.ctrl_state),
                        velx=torch.full_like(joy.velx, 0.2))
    pools = dict(rescue_capacity=2, rescue_iters=4, device=device)
    carry2 = batched.batched_closed_loop_step(
        cfg_p, params2, terrain2, carry2, joy_w, dt, substeps=2,
        admm_backend="pallas_shared", kkt_backend="reduced_admm",
        kkt_reduced_nr=64, kkt_big_capacity=1, **pools)

    (kc,) = shard((batched.make_kkt_carry(cfg_p, n, device=device),))
    carry3, kc = batched.batched_closed_loop_step(
        cfg_p, params2, terrain2, carry2, joy_w, dt, substeps=2,
        admm_backend="pallas_shared", kkt_backend="amortized",
        kkt_carry=kc, kkt_amortize_capacity=1, kkt_refine_order=2, **pools)
    return dict(err=err, mean_err=mean_err, carry_step=carry,
                carry_reduced=carry2, carry_amortized=carry3, kkt_carry=kc)


def dryrun_multichip(n_devices: int, device=CUDA) -> dict:
    """:func:`dryrun_cases` on the 1-D scenario mesh over the process
    group's ``n_devices`` ranks (``parallel.mesh.multihost_init``),
    checked as the JAX dry run checks its cases: shapes, no NaN over the
    mesh, the amortized carry's ages. Returns the cases' results."""
    from a1_qp_mpc_controller_tpu_torch.parallel import mesh as meshmod

    device = resolve_device(device)
    if not dist.is_initialized() or dist.get_world_size() != n_devices:
        raise RuntimeError(
            f"dryrun_multichip({n_devices}) needs a process group of "
            f"{n_devices} ranks (parallel.mesh.multihost_init)")
    mesh = meshmod.make_mesh()
    out = dryrun_cases(n_devices, mesh, device)
    heights = torch.stack([out[k].ps.root_pos[:, 2] for k in (
        "carry_step", "carry_reduced", "carry_amortized")])
    bad = meshmod.amax(torch.isnan(torch.cat([
        heights.flatten(), out["mean_err"].reshape(1)])).float(), mesh)
    assert out["err"].shape == (PER_RANK,), out["err"].shape
    assert heights.shape == (3, PER_RANK), heights.shape
    assert out["kkt_carry"].age.shape == (PER_RANK,)
    assert not bool(bad), "NaN in the dry run"
    return out


def main(argv=None) -> None:
    from a1_qp_mpc_controller_tpu_torch.parallel import mesh as meshmod

    p = argparse.ArgumentParser(prog="a1_qp_mpc_controller_tpu_torch.entry")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (the default is the CUDA card)")
    device = resolve_device("cpu" if p.parse_args(argv).cpu else "cuda")
    # join the group and bind this rank's card before any tensor is made
    device = (meshmod.multihost_init(device=device)
              or meshmod.multihost_init(meshmod.local_coordinator(), 1, 0,
                                        device=device))
    try:
        fn, args = entry(device)
        print("entry() ok: torques", tuple(fn(*args)[2].shape), flush=True)
        dryrun_multichip(dist.get_world_size(), device)
        print(f"rank {dist.get_rank()}: dryrun_multichip ok", flush=True)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
