"""CLI entry points (counterpart of ``__main__.py``), the counterparts of
the reference's three Main executables (MainGazebo/MainHardware/
MainIsaac, SURVEY.md §1 L5):

  python -m a1_qp_mpc_controller_tpu_torch sim       # closed-loop rollout (batch of 1)
  python -m a1_qp_mpc_controller_tpu_torch realtime  # wall-clock 400 Hz harness
  python -m a1_qp_mpc_controller_tpu_torch batch     # domain-randomized batch
  torchrun --nproc-per-node N -m a1_qp_mpc_controller_tpu_torch batch
                                                     # the batch over N ranks
  python -m a1_qp_mpc_controller_tpu_torch golden    # force-trajectory gate
  python -m a1_qp_mpc_controller_tpu_torch wire      # UDP loop vs loopback mock robot

Every command runs on the CUDA card; ``--cpu`` (before the command) runs
it on the CPU instead. Without ``--cpu`` and without a card, a command
exits non-zero: it never falls back to the CPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import threading

import torch


def _assert_time_source(cfg, profile: str, executor: str,
                        override: bool) -> None:
    """Startup precondition parity: the reference's sim mains refuse to
    run unless /use_sim_time is true (MainGazebo.cpp:31-37) and the
    hardware main refuses unless it is false (MainHardware.cpp:30-37):
    a profile tuned for the wrong time source integrates the MPC with
    the wrong dt (the hardware pin exists because a slowed thread once
    produced over-current forces, A1RobotControl.cpp:458-467). Executors
    that advance simulated time ('sim', 'batch', 'golden') require
    use_sim_time profiles; wall-clock executors ('realtime', 'wire')
    require hardware (use_sim_time=false) profiles."""
    wants_sim = executor in ("sim", "batch", "golden")
    if cfg.use_sim_time != wants_sim and not override:
        kind = "simulated-time" if wants_sim else "wall-clock"
        raise SystemExit(
            f"startup precondition: '{executor}' is a {kind} executor "
            f"but profile '{profile}' has use_sim_time="
            f"{cfg.use_sim_time} (reference parity: MainGazebo.cpp:31-37"
            f" / MainHardware.cpp:30-37). Pass a matching profile or "
            f"--override-sim-time-check to proceed anyway (the runners "
            f"here drive simulated robots, so the override is safe in "
            f"this environment).")


def _parse_terrain(spec: str, device):
    """The terrain of one scenario (a batch of one) from ``flat``,
    ``slope[:RAD]`` or ``stairs[:HEIGHT]``."""
    from a1_qp_mpc_controller_tpu_torch.sim import terrain as tr
    if spec == "flat":
        return tr.Terrain.flat(1, device=device)
    kind, _, arg = spec.partition(":")
    if kind == "slope":
        return tr.Terrain.slope(1, float(arg or 0.2), device=device)
    if kind == "stairs":
        return tr.Terrain.stairs(1, step_height=float(arg or 0.09),
                                 device=device)
    raise SystemExit(f"unknown terrain {spec!r} (flat | slope:RAD | "
                     f"stairs:HEIGHT)")


def _profile(args, executor: str):
    """(cfg, params batched to one scenario) of ``args.profile`` on the
    command's device, after the time-source check."""
    from a1_qp_mpc_controller_tpu_torch.config import load_profile
    from a1_qp_mpc_controller_tpu_torch.tensors import broadcast_batch
    cfg, params = load_profile(args.profile, device=args.device)
    _assert_time_source(cfg, args.profile, executor,
                        args.override_sim_time_check)
    return cfg, broadcast_batch(params, 1)


def cmd_sim(args) -> None:
    from a1_qp_mpc_controller_tpu_torch.runtime import telemetry
    from a1_qp_mpc_controller_tpu_torch.sim import closed_loop as cl
    from a1_qp_mpc_controller_tpu_torch.tensors import tree_map
    cfg, params = _profile(args, "sim")
    cfg = dataclasses.replace(cfg, mpc_qp_iters=args.mpc_iters,
                              mpc_solver_mode=args.solver_mode)
    terrain = _parse_terrain(args.terrain, args.device)
    n_steps = int(args.seconds / cfg.control_dt)
    walk_after = int(args.walk_after / cfg.control_dt)
    if args.plant == "joint":
        from a1_qp_mpc_controller_tpu_torch.sim import joint_plant as plant
    else:
        from a1_qp_mpc_controller_tpu_torch.sim import plant
    height = 0.35 if args.profile.startswith("isaac") else 0.3
    carry = cl.make_standing_start(cfg, params, terrain, height=height,
                                   plant=plant, device=args.device)
    joy = cl.joy_schedule(n_steps, walk_after=walk_after, velx=args.velx,
                          vely=args.vely, yaw_rate=args.yaw_rate,
                          device=args.device)
    carry, trace = cl.rollout(cfg, params, terrain, carry, joy, n_steps,
                              plant=plant, device=args.device)
    trace = tree_map(lambda a: a[:, 0], trace)   # the one scenario
    summary = telemetry.summarize_trace(trace)
    if args.trace_out:
        telemetry.save_npz(trace, args.trace_out)
        summary["trace_file"] = args.trace_out
    print(json.dumps(summary, indent=2))


def cmd_realtime(args) -> None:
    from a1_qp_mpc_controller_tpu_torch.runtime.realtime import (
        RealtimeRunner,
    )
    from a1_qp_mpc_controller_tpu_torch.types import JoyCmd
    _profile(args, "realtime")
    with RealtimeRunner(profile=args.profile,
                        mpc_iters=args.mpc_iters,
                        solver_mode=args.solver_mode,
                        estimation_rate_hz=(500.0 if args.sensor_rate_ekf
                                            else None),
                        telemetry_jsonl=(args.telemetry_jsonl or None),
                        device=args.device) as runner:
        joy = JoyCmd.zeros(device=args.device)
        if args.walk:
            joy = joy.replace(ctrl_state=torch.ones_like(joy.ctrl_state),
                              velx=torch.full_like(joy.velx, args.velx))
        stats = runner.run(args.seconds, joy)
    print(json.dumps(stats, indent=2))


def cmd_batch(args) -> None:
    """The domain-randomized batched rollout. Under a launcher
    (``torchrun``) every rank joins the group and binds its card before
    it makes a tensor, builds the same global batch from the seed, runs
    its block of it, and rank 0 prints the global metrics; started
    plainly it is one rank."""
    import torch.distributed as dist

    from a1_qp_mpc_controller_tpu_torch.config import load_profile
    from a1_qp_mpc_controller_tpu_torch.parallel import batched
    from a1_qp_mpc_controller_tpu_torch.parallel import mesh as meshmod
    from a1_qp_mpc_controller_tpu_torch.sim import closed_loop as cl
    rank_device = meshmod.multihost_init(device=args.device)
    device = args.device if rank_device is None else rank_device
    mesh = None if rank_device is None else meshmod.make_mesh()
    try:
        cfg, params = load_profile(args.profile, device=device)
        _assert_time_source(cfg, args.profile, "batch",
                            args.override_sim_time_check)
        cfg = dataclasses.replace(cfg, mpc_qp_iters=args.mpc_iters,
                                  mpc_solver_mode="fixed")
        pb, tb, carry = (meshmod.shard_batch(tree, mesh)
                         for tree in batched.make_batch(
                             cfg, torch.Generator().manual_seed(args.seed),
                             args.n, params, device=device))
        joy_seq = cl.joy_schedule(args.steps, walk_after=args.steps // 4,
                                  velx=args.velx, device=device)
        carry, errs, metrics = batched.batched_rollout(
            cfg, pb, tb, carry, joy_seq, args.steps, mesh=mesh,
            device=device)
        if meshmod.block(mesh)[0] == 0:
            print(json.dumps({k: float(v) for k, v in metrics.items()},
                             indent=2))
    finally:
        if mesh is not None:
            dist.destroy_process_group()


def cmd_golden(args) -> None:
    from a1_qp_mpc_controller_tpu_torch.runtime.golden import run_gate
    _profile(args, "golden")
    rep = run_gate(seconds=args.seconds, sample_every=args.sample_every,
                   velx=args.velx,
                   terrain=_parse_terrain(args.terrain, args.device),
                   profile=args.profile, solver_mode=args.solver_mode,
                   mpc_iters=args.mpc_iters, device=args.device)
    print(json.dumps(rep, indent=2))
    if rep["nan"] or rep["frac_within_tol"] < 1.0:
        sys.exit(1)


def cmd_wire(args) -> None:
    """Hardware transport loop against the loopback mock robot: the
    zero-torque udp_init_send handshake, then the 500 Hz LowState /
    LowCmd exchange with sensor-rate estimation and 400 Hz control
    (HardwareA1ROS.cpp:230-260 parity for the wire)."""
    from a1_qp_mpc_controller_tpu_torch.runtime import wire
    from a1_qp_mpc_controller_tpu_torch.types import JoyCmd
    cfg, params = _profile(args, "wire")
    cfg = dataclasses.replace(cfg, mpc_qp_iters=args.mpc_iters,
                              mpc_solver_mode=args.solver_mode)
    mock = wire.MockA1Robot(params, _parse_terrain(args.terrain, args.device),
                            device=args.device)
    try:
        runner = wire.HardwareWireRunner(cfg, params, mock.addr,
                                         device=args.device)
        try:
            n_hs = 10
            t = threading.Thread(target=lambda: [mock.serve_once()
                                                 for _ in range(n_hs)])
            t.start()
            got = runner.handshake(n_hs)
            t.join()
            rep = runner.run(args.seconds, JoyCmd.zeros(device=args.device),
                             mock)
            rep["handshake_replies"] = got
            rep["zero_torque_cmds_before_control"] = mock.zero_torque_cmds
            print(json.dumps(rep, indent=2))
        finally:
            runner.close()
    finally:
        mock.close()


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="a1_qp_mpc_controller_tpu_torch")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (the default is the CUDA card)")
    sub = p.add_subparsers(dest="cmd", required=True)

    def common(sp):
        sp.add_argument("--profile", default="gazebo_mpc")
        sp.add_argument("--mpc-iters", type=int, default=400)
        sp.add_argument("--solver-mode", default="adaptive",
                        choices=["adaptive", "fixed"])
        sp.add_argument("--velx", type=float, default=0.3)
        sp.add_argument("--seconds", type=float, default=5.0)
        sp.add_argument("--terrain", default="flat")
        sp.add_argument("--override-sim-time-check", action="store_true",
                        help="bypass the use_sim_time/executor "
                             "consistency refusal (reference parity: "
                             "MainGazebo.cpp:31-37)")

    ps = sub.add_parser("sim", help="closed-loop rollout")
    common(ps)
    ps.add_argument("--plant", default="srb", choices=("srb", "joint"),
                    help="physics backend: SRB + massless legs (default) "
                         "or 18-DoF articulated dynamics")
    ps.add_argument("--vely", type=float, default=0.0)
    ps.add_argument("--yaw-rate", type=float, default=0.0)
    ps.add_argument("--walk-after", type=float, default=1.0)
    ps.add_argument("--trace-out", default="")
    ps.set_defaults(fn=cmd_sim)

    pr = sub.add_parser("realtime", help="wall-clock 400 Hz harness")
    common(pr)
    pr.add_argument("--walk", action="store_true")
    pr.add_argument("--telemetry-jsonl", default="",
                    help="live debug stream: append one JSON line of "
                         "pose/contacts/GRF/torque state every 10 ticks "
                         "(tail -f it: the rviz-topic stand-in)")
    pr.add_argument("--sensor-rate-ekf", action="store_true",
                    help="run the EKF at the 500 Hz sensor rate (the "
                         "reference's hardware receive-thread schedule)")
    pr.set_defaults(fn=cmd_realtime, mpc_iters=50, solver_mode="fixed",
                    profile="hardware_qp")  # wall-clock executor

    pb = sub.add_parser("batch", help="domain-randomized batched rollout "
                                      "(split over a launcher's ranks)")
    common(pb)
    pb.add_argument("--n", type=int, default=64)
    pb.add_argument("--steps", type=int, default=400)
    pb.add_argument("--seed", type=int, default=0)
    pb.set_defaults(fn=cmd_batch, mpc_iters=50)

    pg = sub.add_parser("golden", help="force-trajectory gate vs float64")
    common(pg)
    pg.add_argument("--sample-every", type=int, default=50)
    pg.set_defaults(fn=cmd_golden, seconds=10.0)

    pw = sub.add_parser("wire", help="UDP LowState/LowCmd loop vs the "
                                     "loopback mock robot")
    common(pw)
    pw.set_defaults(fn=cmd_wire, mpc_iters=50, solver_mode="fixed",
                    seconds=1.0, profile="hardware_qp")  # wall-clock

    args = p.parse_args(argv)
    from a1_qp_mpc_controller_tpu_torch.tensors import resolve_device
    try:
        args.device = resolve_device("cpu" if args.cpu else "cuda")
    except RuntimeError as e:
        raise SystemExit(f"{p.prog} {args.cmd}: {e}") from None
    args.fn(args)


if __name__ == "__main__":
    main()
