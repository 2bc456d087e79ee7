"""Multi-host worker: one rank of an N-process ``torch.distributed`` run
(counterpart of ``scripts/multihost_worker.py``).

    python -m a1_qp_mpc_controller_tpu_torch.scripts.multihost_worker \\
        <process_id> <num_processes> <port> [--local-ranks L] [--cpu]

Each of the N processes joins the group at ``127.0.0.1:<port>``
(``parallel.mesh.multihost_init``: NCCL where each local rank has a card
of its own, gloo on the CPU or where ranks share a card), forms the
(hosts x local ranks) mesh with ``L`` ranks a host (default N: one host),
and, from the same seeded global batch on every rank, runs its block of:

1. ``make_bench_state`` at one scenario a rank, 12 ticks of
   ``batched_control_tick`` on 'xla' (past the 10-tick zero-torque
   warmup shield);
2. two scenarios a rank from a second seed, 3 ticks of the production
   route ('pallas_shared' / 'reduced_admm' at ``kkt_reduced_nr=64``,
   pools sized per shard);
3. 3 ticks of the 'amortized' route from 2's state with a per-shard
   ``KktCarry``.

Each phase's mean |tau| and max |tau| over the last tick are reduced
across the ranks (``parallel.mesh.mean`` / ``amax``) and printed, then
``MULTIHOST_OK`` and the three means, equal on every rank.
"""

from __future__ import annotations

import argparse
import dataclasses

import torch

from a1_qp_mpc_controller_tpu_torch.tensors import const, resolve_device

XLA_TICKS = 12
ROUTE_TICKS = 3
POOLS = dict(rescue_capacity=2, rescue_iters=4)


def block_torques(idx: int, count: int, device) -> dict:
    """Block ``idx`` of ``count`` of the three phases' global batches
    (``count`` and ``2 * count`` scenarios): each phase's torques at its
    last tick, (scenarios of the block, 12)."""
    from a1_qp_mpc_controller_tpu_torch.config import load_profile
    from a1_qp_mpc_controller_tpu_torch.parallel import batched
    from a1_qp_mpc_controller_tpu_torch.parallel.mesh import take_block
    from a1_qp_mpc_controller_tpu_torch.types import JoyCmd

    cfg, params = load_profile("gazebo_mpc", device=device)
    cfg = dataclasses.replace(cfg, mpc_qp_iters=10, mpc_solver_mode="fixed")
    joy = JoyCmd.zeros(device=device)
    joy = joy.replace(ctrl_state=torch.ones_like(joy.ctrl_state),
                      velx=torch.full_like(joy.velx, 0.2))
    dt = const(cfg.control_dt, torch.float32, device)
    blk = lambda trees: tuple(take_block(t, idx, count) for t in trees)
    out = {}

    pb, cs, mem, sensors = blk(batched.make_bench_state(
        cfg, torch.Generator().manual_seed(0), count, params, device=device))
    for _ in range(XLA_TICKS):
        cs, mem, tq = batched.batched_control_tick(
            cfg, pb, cs, mem, sensors, joy, dt, admm_backend="xla")
    out["xla"] = tq

    pb2, cs2, mem2, sensors2 = blk(batched.make_bench_state(
        cfg, torch.Generator().manual_seed(1), 2 * count, params,
        device=device))
    mem2 = mem2.replace(tick=torch.full_like(mem2.tick, XLA_TICKS))
    for _ in range(ROUTE_TICKS):
        cs2, mem2, tq = batched.batched_control_tick(
            cfg, pb2, cs2, mem2, sensors2, joy, dt,
            admm_backend="pallas_shared", kkt_backend="reduced_admm",
            kkt_reduced_nr=64, kkt_big_capacity=1, **POOLS)
    out["production"] = tq

    (kc,) = blk((batched.make_kkt_carry(cfg, 2 * count, device=device),))
    for _ in range(ROUTE_TICKS):
        cs2, mem2, tq, kc = batched.batched_control_tick(
            cfg, pb2, cs2, mem2, sensors2, joy, dt,
            admm_backend="pallas_shared", kkt_backend="amortized",
            kkt_carry=kc, kkt_amortize_capacity=1, kkt_refine_order=2,
            **POOLS)
    out["amortized"] = tq
    return out


def main(argv=None) -> None:
    import torch.distributed as dist

    from a1_qp_mpc_controller_tpu_torch.parallel import mesh as meshmod

    p = argparse.ArgumentParser()
    p.add_argument("process_id", type=int)
    p.add_argument("num_processes", type=int)
    p.add_argument("port", type=int)
    p.add_argument("--local-ranks", type=int, default=None,
                   help="ranks a host (default: all, one host)")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (the default is the CUDA card)")
    args = p.parse_args(argv)
    pid = args.process_id
    device = meshmod.multihost_init(
        f"127.0.0.1:{args.port}", args.num_processes, pid,
        local_ranks=args.local_ranks,
        device=resolve_device("cpu" if args.cpu else "cuda"))
    try:
        world = dist.get_world_size()
        assert world == args.num_processes, world
        mesh = meshmod.make_host_chip_mesh(args.local_ranks or world)
        print(f"proc {pid}: processes={world} backend={dist.get_backend()} "
              f"mesh={tuple(mesh.mesh.shape)} "
              f"axes={','.join(mesh.mesh_dim_names)}", flush=True)
        tq = block_torques(*meshmod.block(mesh), device)
        means = []
        for name, label in (("xla", ""), ("production", "production-route "),
                            ("amortized", "amortized-route ")):
            mean_v = float(meshmod.mean(torch.abs(tq[name]), mesh))
            max_v = float(meshmod.amax(torch.abs(tq[name]), mesh))
            assert mean_v > 0.0 and mean_v == mean_v, (name, mean_v)
            print(f"proc {pid}: {label}mean|tau|={mean_v:.6f} "
                  f"max|tau|={max_v:.6f}", flush=True)
            means.append(mean_v)
        print(f"proc {pid}: MULTIHOST_OK "
              + " ".join(f"{v:.6f}" for v in means), flush=True)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
