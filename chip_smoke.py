#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``a1_qp_mpc_controller_tpu_torch``) on one
NVIDIA card and check it.

    python3 chip_smoke.py

Phases, in order:

1. device: the card's name and power limit (``nvidia-smi``);
2. build: the seven CUDA sources from
   ``a1_qp_mpc_controller_tpu_torch/csrc`` with nvcc for ``sm_90a`` (one
   nvcc process each, all at once; ptxas registers and spills logged by
   kernel), and the occupancy of the register kernel of
   ``csrc/inverse_t.cu`` that K1 and K3 launch at n = 32, 64, 66 and 120,
   of ``csrc/gj_rank.cu``'s register tile (K6d, K6e) at n = 32 and 120,
   of K2's register tiers at (n, m) = (120, 200) and (66, 110) and of
   ``csrc/chol_linv.cu``'s tiers (K5) at p = 8, 16, 30 and 64 (resident
   blocks by CUDA's calculator, registers, spill bytes; K2's and K5's
   register tiers must not spill);
3. the kernels against their plain PyTorch versions on the operands of a
   real B = 1024 trot tick, at every shape a driven route gives them:
   - K1 (Gauss-Jordan KKT inverse, the "diag - 1" rule set of
     ``csrc/inverse_t.cu``) at B = 40/48/80/96/128/160/192/1024 (rescue
     rounds, capacity refresh, the big bucket, refresh-all) and at the
     amortized gate's 16/8/2 (refresh-all and the 'gj' column, the
     rescue rounds, the refresh), bit for bit;
   - K2 (fused shared-basis ADMM: a pack launch of the shared basis's
     nonzeros, then the iterations) at n = 120, m = 200 (B = 1024 and
     the big bucket's 160 with 25 iterations; B = 1024 and the
     150-iteration pools of 192/96/80/48/40 with 150; the amortized
     gate's B = 16 with 25, and its pools of 16/8/4 with 150) and at the
     reduced tier's n = 66, m = 110 (B = 1024 with 25 iterations, pools
     of 192 and 48 with 150);
   - K3 (Gauss-Jordan inverse, small n: K1's rule set on a register tile
     sized to n) at (1024, 66), (192, 66), (48, 66) and (1024, 64), and
     at (1024, 32) on the leading 32 x 32 block of the KKT batch (the
     Schur recursion's base, K6a), bit for bit;
   - K4 (fused ADMM, per-scenario A) at B = 1024, n = 120, m = 200, 25
     iterations, and at B = 64 with a dense random A, which overflows the
     kernel's nonzero lists and runs the dense order; the blocks that ran
     it counted per row;
   - exact float32 products (TF32 off, a panel product against float64);
   - K5 (panel Cholesky inverse: one warp a panel in registers for
     p <= 32, a block a panel in shared memory past it) at (1024, 30, 30)
     on the first diagonal panel of the full-size KKT batch and on the
     last, trailing one as ``spd_cholesky_inverse_hybrid`` gives it to
     K5, and on the batch's leading p x p blocks at p = 1, 7, 8, 31, 32
     (the register tier's edges) and 33, 64 (the shared-memory tier), bit
     for bit, each timed beside ``cholesky`` + ``solve_triangular``; the
     hybrid itself on the whole batch, its K5 launches counted from 0,
     held to ||MX - I||_max <= 1e-3 beside ``spd_cholesky_inverse`` (the
     'chol' route's inverse);
   - K6g (batch-last Gauss-Jordan) and the batch-last sweep kernel (K6j,
     shared by K6h, K6i and K6k; both pivot-column reads) at (1024, 120),
     bit for bit; then the register tile under each rule set but K1's
     (K6g, the sweep, K6b, K6f) beside ``torch.linalg.inv``, timed in
     turns;
   - K6a (Schur recursion, K3 at the base) against itself with K3's plain
     version at the base: the same NaN pattern, the finite entries within
     1e-5 of their scale; its finite share and ||MX - I||_max reported;
   - K6b-K6f (one-array, [M | I], rank-r panel and corrected rank-r panel
     Gauss-Jordan, batch-leading sweep) at (1024, 120) and (64, 30), K6d
     at ranks 2 and 4 and K6e at 8 and 4 at both (padded to 32 pivots at
     ranks 4 and 8), bit for bit, ||MX - I||_max reported; K6b and K6f
     (``csrc/inverse_t.cu``) also at (64, 136), past the register tile,
     all three compared as int32 views so that signed zeros count; K6d's
     and K6e's register tile beside ``torch.linalg.inv`` at (1024, 120),
     timed in turns, and the wide tier past the tile, at (64, 136), bit
     for bit;
4. the routes at B = 1024 on ``gazebo_mpc`` with the bench schedule: the
   bench warm-up (120 stand and 380 trot ticks on 'gj'), then, each from
   a copy of that one warmed state, 'amortized' and the bench's 'full'
   candidate and the reduced tier of 'reduced_admm' (40 untimed and 100
   timed ticks each), then 'reduced', the legacy 'pallas' route, 'gj',
   'chol', 'schur', 'sweep_t', 'gj_t' and 'xla' with ``torch.linalg.inv``
   and with K1 (4 untimed and 20 timed). The
   launch counts are set to 0 just before each route's ticks (and before
   the 'gj' warm-up) and read just after; every kernel of a route must
   have launched on it. Every route but 'schur' (documented unsafe on
   this family: reported, not held) must keep every scenario alive;
   'chol', 'sweep_t' and 'gj_t' must converge within 0.005 of 'gj', both
   'xla' routes within 0.005 of the legacy 'pallas' route (the one with
   K1 shares its inverse and differs only in the ADMM). Then, from copies
   of the same warmed state, three closed-loop ticks of ``control_tick``
   over the batch in fixed and in adaptive mode (its own solve; the host
   reads of the adaptive loop counted), and the component profile
   (``runtime.components``: the tick, the build, the KKT assemblies,
   every KKT inverse with ||MX - I||_max, the ADMM solves, the batched
   ticks), its launch counts set to 0 just before it and read just
   after: every kernel it times must have launched. A
   small batch is then run through the same first trot ticks on the card
   and on the CPU (plain versions), which must agree in their torques,
   forces, contacts and carried controller state: on 'gj', 'amortized',
   'chol', 'sweep_t', 'gj_t', 'xla' (with ``torch.linalg.inv`` and with
   K1) and ``control_tick`` in both modes from one state, on 'full', the
   reduced tier and the legacy 'pallas' route (K1 and K4) tick by tick
   from the card's state; and 'full' free for 3 ticks against the CPU
   with K2's plain version summing the x-update as the kernel does (in
   float64, rounded once), the plain CPU's and the card's distances from
   K2's iterations in float64 reported beside;
5. the scripts' paths and kernels: the port's scripts as a user runs
   them, the launch counts set to 0 before each and read after:
   ``micro_admm`` (S1, four variants x unroll 1 and 4 at B = 1024, each
   timed and checked against its plain version at 3 iterations on every
   scenario and at the script's 50 on the scenarios float32 leaves
   stable; 'nominv', which diverges there, must leave the finite numbers
   in both; the unrolls bit-equal), the two probe ladders (S2, timed,
   bit for bit), ``probe_mosaic3`` and ``probe_mosaic4`` (the grid
   negate over (120, 120, 1024), the masked sweeps K6j/K6k on the
   reference KKT batch, ||I - XM||_max <= 1e-3); then S1's and S2's rows
   from those runs, each S2 probe also held bit for bit on seeded random
   inputs, beside its plain version's time, and every S2 body at the odd
   shapes of ``S2_ODD_SHAPES`` (ni != nj, padded tiles, odd lane counts,
   the shared-memory tier past the chains and the tile) at n = 0, 1, the
   most and one below half of it; the two bodies with a
   library call (negate; fori_mask over every column, ``m * 2``) timed
   in turns with that call on the same input at (8, 8, 128),
   (120, 120, 128) and (120, 120, 1024), the ladder's own time kept
   beside;
6. the stand-QP path on ``gazebo_qp`` in fixed mode: B = 4096 scenarios
   with staggered gait phases through ``batched_stand_control_tick``
   (rescue pool 128 x 400; 200 stand and 40 trot ticks untimed, 100
   timed, a profile of 5 more), ``control_tick`` in both modes at
   B = 1024 (3 ticks), a B = 8 card-vs-CPU check of both from one
   CPU-stood state, and the stand gate (``runtime.golden.
   run_stand_batched_gate(1.0, 2, 3)``) beside ``GOLDEN_REPORT.json``;
   then the MPC golden gates (``runtime.golden``, the float64 solves in
   a pool of the host's cores but one): the batched amortized gate at
   its record's protocol (16 scenarios of the record's draws, 2.5 s,
   every 3rd tick from the onset: 3,200 samples; the bench route, K1
   and K2, their launches counted from 0 just before it), which must
   keep every scenario alive and hold 0.97 of its samples within 2 N,
   and a short ``fixed_25it_rescue`` gate (the shipped schedule through
   ``control_tick``, 2 s, every 10th tick from the onset at 1 s), every
   sample within 2 N; no NaN in either; each gate's wall time printed;
   then the terrain evaluation of ``bench.py``'s ``bench_terrain_eval``
   on the port (``parallel.batched.make_batch`` of 256 randomized
   scenarios on flat, sloped and stepped ground, ``batched_rollout`` of
   400 steps walking from step 100, a warm rollout and a timed one from
   where it ended): alive 1.0 and no NaN required, the height errors
   overall and by kind printed beside the JAX package's record; and the
   hardware's dual-rate schedule (``runtime.realtime.run_dual_rate_sim``,
   2 s, the EKF at 500 Hz and control at 400 Hz, walking from 1 s), held
   to ``tests/test_runtime.py``'s asserts; the kernels' launches counted
   from 0 just before each and read just after (neither runs a hand
   kernel: the tick's solve is ``control_tick``'s, as in the JAX
   package); then the runtime and the CLI (phase 6g): the native
   executor (``runtime/native.py``) built with g++ from the port's
   ``native/rt_executor.cc`` and held to ``tests/test_runtime.py``'s ring
   and loop checks, a raising callback failing ``stop()`` with its first
   exception; ``RealtimeRunner`` for 1 s in each schedule (sim parity,
   and the EKF at the 500 Hz sensor rate), its telemetry records counted
   against its ticks, the plant finite with 0.1 < z < 0.5, its tick also
   timed alone; then the five CLI commands (``python -m
   a1_qp_mpc_controller_tpu_torch sim|realtime|batch|golden|wire``) and
   the two time-source refusals, all at once as subprocesses on the
   card, each exiting as the JAX package's would, while the wire loop
   runs here in the native format for 1 s (500 frames, 400 ticks) and in
   the SDK format for 0.5 s (250, 200), each after its handshake, under
   ``tests/test_wire.py``'s assertions (among the processes also ``sim
   --plant joint --seconds 0.5`` and ``batch`` over two ``torchrun``
   ranks sharing the card, gloo, rank 0 printing the global metrics);
   then the articulated plant (phase 6h): one ``_substep`` and one
   ``plant_step`` at B = 1024 from seeded states on the card against the
   CPU in float64 (every field within 1e-8, the flags equal) and float32
   (``tests/test_torch_joint_plant.py``'s limits), the physics of
   ``tests/test_joint_plant.py`` on the card, and its trot and Isaac walk
   onset through ``rollout(plant=joint_plant)``, in two processes side by
   side (``chip_smoke.py --joint-rollout NAME``), each with its wall time,
   ms a tick, ``plant_step`` alone and its host reads; and the mesh
   (phase 6i): ``entry.dryrun_multichip(1)`` under NCCL, K1, K2 and K3
   launched and every case bit-equal to the same routes without the mesh,
   and the port's worker as two gloo ranks on the card, equal to one
   process's run of each rank's block;
7. one JSON line listing each kernel, then the device line.

Every failed check raises. The script needs a CUDA card and the
repository around it; without either it exits non-zero and prints no
result. Ends with one JSON line:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PKG = "a1_qp_mpc_controller_tpu_torch"
PALLAS = "a1_qp_mpc_controller_tpu/ops/pallas_kernels.py"
RETIRED = "a1_qp_mpc_controller_tpu/ops/pallas_retired.py"
TRACE_DIR = ROOT / "build" / "traces"     # .gitignore lists build/

BATCH = 1024
STAND_TICKS = 120          # bench.py _warm_trot
WALK_TICKS = 380
SMALL_BATCH = 8
# bench.py build(): the round-5 schedule
SCHEDULE = dict(mpc_qp_iters=25, mpc_solver_mode="fixed",
                mpc_cooldown_ticks=32, mpc_cooldown_stride=4,
                mpc_cooldown_dense=12, mpc_drift_rescue_n=0.5)
RESCUE = dict(rescue_capacity=192, rescue_iters=150)
GJ_KW = dict(admm_backend="pallas_shared", kkt_backend="gj", **RESCUE)
# bench.py _tick_kwargs: 'amortized' and 'full'; the reduced tier and
# 'reduced' at the same settings with the reduced tier of 64 variables
AMORTIZED_KW = dict(admm_backend="pallas_shared", kkt_backend="amortized",
                    kkt_amortize_capacity=128, kkt_refine_order=3, **RESCUE)
FULL_KW = dict(admm_backend="pallas_shared", kkt_backend="reduced_admm",
               kkt_reduced_nr=128, kkt_big_capacity=160, **RESCUE)
TIER_KW = dict(FULL_KW, kkt_reduced_nr=64)
REDUCED_KW = dict(TIER_KW, kkt_backend="reduced")
LEGACY_KW = dict(admm_backend="pallas", use_pallas=True)
# the per-tick-refactor routes that differ from 'gj' only in the inverse
CHOL_KW, SCHUR_KW, SWEEP_KW, GJ_T_KW = (
    dict(GJ_KW, kkt_backend=k) for k in ("chol", "schur", "sweep_t", "gj_t"))
# the JAX package's default route, with either inverse
XLA_KW = dict(admm_backend="xla")
XLA_K1_KW = dict(admm_backend="xla", use_pallas=True)
# control_tick over the batch (the JAX package's tick under vmap): mode ->
# config overrides; fixed runs the schedule's 25 iterations, adaptive
# solves to 1e-5 within the profile's 100 iterations, then 75 more
CONTROL_TICK_MODES = {"fixed": {}, "adaptive": dict(
    mpc_solver_mode="adaptive", mpc_qp_iters=100)}
K1, K2 = "batched_inverse", "fused_admm_shared"
K3, K4 = "batched_inverse_small", "fused_admm"
K5, K6G = "batched_chol_linv", "batched_inverse_T"
K6S = "batched_inverse_sweep_T"
K6B, K6C = "batched_inverse_inplace", "batched_inverse_combined"
K6D, K6E = "batched_inverse_rank", "batched_inverse_rank_masked"
# the ranks the component profile gives K6d and K6e (runtime/components.py)
K6D_RANKS, K6E_RANKS = (2, 4), (8, 4)
K6F = "batched_inverse_spd"
# the CUDA kernels each route's profile reports by name: label -> parts
# of the profiler's name, any of which marks it: K2's two
# (csrc/fused_admm_shared.cu), K1 and K3 (the "diag - 1" rule set,
# Rule::kK1, of csrc/inverse_t.cu: the routes give K1 n = 120 and 160, the
# tile of R = 8 and the kernel past n = 128, and K3 n = 32, 64 and 66,
# the smaller tiles) and K4 (csrc/fused_admm.cu)
_K1_RULE = "((anonymous namespace)::Rule)2>"
NAMED_KERNELS = {
    "K1": (f"reg_kernel<8, {_K1_RULE}", f"large_kernel<{_K1_RULE}"),
    "K3": tuple(f"reg_kernel<{r}, {_K1_RULE}" for r in range(1, 8)),
    "K2": ("fused_admm_shared_kernel",), "K2 pack": ("pack_basis_kernel",),
    "K4": ("fused_admm_kernel<",)}
# the kernels the component profile times (runtime/components.py)
PROFILE_KERNELS = {K1, K2, K4, K6B, K6C, K6D, K6E, K6F, K6G, K6S}
# route: (tick keyword arguments, untimed ticks, timed ticks, the kernels
# that must launch on it)
ROUTES = {
    "amortized": (AMORTIZED_KW, 40, 100, {K1, K2}),
    "full": (FULL_KW, 40, 100, {K1, K2}),
    "reduced_tier": (TIER_KW, 40, 100, {K1, K2, K3}),
    "reduced": (REDUCED_KW, 4, 20, {K1, K2, K3}),
    "pallas": (LEGACY_KW, 4, 20, {K1, K4}),
    "gj": (GJ_KW, 4, 20, {K1, K2}),
    "chol": (CHOL_KW, 4, 20, {K2}),
    "schur": (SCHUR_KW, 4, 20, {K3, K2}),
    "sweep_t": (SWEEP_KW, 4, 20, {K6S, K2}),
    "gj_t": (GJ_T_KW, 4, 20, {K6G, K2}),
    "xla": (XLA_KW, 4, 20, set()),
    "xla_k1": (XLA_K1_KW, 4, 20, {K1}),
}
# routes whose solve carries the rescue pool, held to the converged limit
CONVERGED_ROUTES = ("amortized", "full", "reduced_tier")
# routes of the same numerics class as 'gj' (sequential elimination or
# Cholesky), held to within CONVERGED_GAP below 'gj''s converged fraction
# from the same state; 'schur' is documented unsafe on this family and
# is reported, not held (neither alive nor converged)
LIKE_GJ = ("chol", "sweep_t", "gj_t")
# the 'xla' routes against the legacy route, the same inverse and
# iterations with the ADMM in plain PyTorch instead of K4
LIKE_LEGACY = ("xla", "xla_k1")
CONVERGED_GAP = 0.005
UNHELD_ALIVE = ("schur",)
# the small card-vs-CPU check: route -> (tick keyword arguments, whether
# each CPU tick starts from the card's state). Below B = 160 the big
# bucket would hold the whole batch, so the reduced tier gets one of 2.
# Both 'reduced_admm' routes, the reduced tier and 'full', run tick by
# tick from the card's state: their rescued stepsize is estimated from
# residuals at the float32 rounding floor and accepted by comparing such
# residuals, so over free-running ticks a change in a sum's order grows
# past the limits (PERF.md, PR 2); the carried state each tick writes is
# compared too, so a fault in it still shows. 'full' also runs free
# (``small_full_free``), against the CPU with K2's plain version summing
# the x-update as the kernel does (in float64, rounded once), and must be
# nearer K2's iterations in float64 than the plain float32 CPU, which
# sums it as one chain (PERF.md §6 has the distances on an H100).
# The legacy route runs tick by tick too: free-running, its torques
# parted by 4.97e-3 N m of the 5e-3 limit after 3 ticks on an H100 (K4
# sums A in another order than the plain version's einsum, and the trot
# amplifies it; PERF.md), a margin that another host's CPU rounding
# could eat.
# The control_tick entries hold config overrides, not tick arguments
SMALL_ROUTES = {
    "gj": (GJ_KW, False),
    "amortized": (dict(AMORTIZED_KW, kkt_amortize_capacity=2), False),
    "full": (FULL_KW, True),
    "reduced_tier": (dict(TIER_KW, kkt_big_capacity=2), True),
    "pallas": (LEGACY_KW, True),
    "chol": (CHOL_KW, False),
    "sweep_t": (SWEEP_KW, False),
    "gj_t": (GJ_T_KW, False),
    "xla": (XLA_KW, False),
    "xla_k1": (XLA_K1_KW, False),
    "control_tick_fixed": (CONTROL_TICK_MODES["fixed"], False),
    "control_tick_adaptive": (CONTROL_TICK_MODES["adaptive"], False),
}
# the controller state a tick carries into the next, compared after each
# small tick: the discrete leaves exactly, the warm start and the
# stepsize within limits
SMALL_EXACT = ("mpc_flip_cooldown", "mpc_warm_started", "mpc_prev_contacts")

# H100 SXM peaks (NVIDIA data sheet): float32 outside the tensor cores,
# device-memory bandwidth
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_S = 3.35e12
SPIN_CYCLES = 20_000_000   # ~10 ms at the H100's ~1.98 GHz boost clock

# tolerances, each with its reason
K1_RESID_TOL = 1e-3    # ||MX - I||_max of sequential Gauss-Jordan on the KKT family
K2_REL_TOL = 1e-4      # A-products summed in another order over the iterations
K4_REL_TOL = 1e-4      # the same, with the per-scenario A
K4_DENSE_BATCH = 64    # the phase 3d row whose dense random A overflows
# K6a with the K3 kernel against K6a with K3's plain version: K3 is
# bit-equal to its plain version, so the products that follow see the
# same operands; the tolerance (of the finite entries' scale) only
# allows for a product library that rounds differently from run to run
K6A_REL_TOL = 1e-5
# exact float32 products: TF32 keeps 10 mantissa bits (~1e-3 relative)
F32_PRODUCT_REL_TOL = 1e-5
SMALL_TQ_TOL = 5e-3    # torques, N m, after 3 ticks (tests/test_parallel.py)
SMALL_F_TOL = 0.05     # ground-reaction forces, N
# the carried state: its first step is the forces above; the later
# steps of the horizon are near-flat directions of the QP, 20x looser
SMALL_WARM_X_TOL = 1.0       # N, over the whole horizon
SMALL_WARM_Y_REL = 1e-3      # the carried dual, of its largest entry
# the carried stepsize is estimated from residuals at the float32
# rounding floor, so it is held only to a factor; a fault shows as a
# jump across its 1000x clamp band
SMALL_RHO_FACTOR = 4.0
SMALL_LIMITS = dict(torque=SMALL_TQ_TOL, force=SMALL_F_TOL,
                    warm_x=SMALL_WARM_X_TOL, warm_y_rel=SMALL_WARM_Y_REL,
                    rho_factor=SMALL_RHO_FACTOR)
CONVERGED_MIN = 0.99   # bench.py's rule: throughput counts at solver accuracy

S1, S2 = "micro_admm", "mosaic_probes"
SCRIPTS = "scripts"
# ||I - XM||_max of the masked sweeps (the inverse kernels read 2.5e-4 to
# 6.4e-4 on the routes' KKT batches)
SWEEP_RESID_TOL = 1e-3
# the stand-QP path (batched_stand_control_tick's docstring size)
STAND_PROFILE = "gazebo_qp"
STAND_BATCH = 4096
STAND_RESCUE = dict(rescue_capacity=128, rescue_iters=400)
STAND_TICKS_QP, WALK_TICKS_QP, TIMED_TICKS_QP = 200, 40, 100
STAND_CONTROL_BATCH = 1024
# the stand QP's float32 floor (tests/test_torch_stand.py): its scaled
# KKT matrix has a condition number of ~1e6 and the solve stops at 1e-4,
# so two float32 codes of the same arithmetic part by up to 0.107 N /
# 0.032 N m on a closed-loop tick; the limits are 1.4x those
SMALL_QP_F_TOL = 0.15        # N
SMALL_QP_TQ_TOL = 0.045      # N m
GATE_MIN_SAMPLES = 300       # tests/test_golden.py's limits
GATE_MAX_DEV = 1.0           # N
# the MPC golden gates: the amortized gate's record protocol gives 3,200
# samples; its share within 2 N must reach the 'gj' column's record
# (GOLDEN_REPORT.json gj_batched_gate, 0.9706), the fixed gate's is 1.0
# as its record's
AMORTIZED_GATE_SAMPLES = 3200
# the shapes the amortized gate (B = 16, refresh 2, rescue pool 4 at 150
# iterations) gives K1 and K2, below one wave: K1's refresh of all 16
# (and the 'gj' column's every tick), its rescue rounds of 16 and 8 and
# its refresh of 2; K2's first pass (16, 25), the continuation pool (4,
# 150; the carried inverse, no K1) and the rescue rounds (16, 150) and
# (8, 150)
GATE_K1_BATCHES = (16, 8, 2)
GATE_K2_SHAPES = ((16, 25), (16, 150), (8, 150), (4, 150))
AMORTIZED_GATE_MIN_FRAC = 0.97
FIXED_GATE = dict(seconds=2.0, sample_every=10)
# K5's panels past the hybrid's p = 30 (leading blocks of the KKT batch):
# the register tier's edges (P = 8, 16, 32) and one past each, and the
# shared-memory tier past it
K5_PS = (1, 7, 8, 31, 32, 33, 64)
K5_REG_MAX = 32
# the terrain evaluation (bench.py bench_terrain_eval): gazebo_mpc, 25
# fixed iterations, B = 256 randomized scenarios on flat, sloped and
# stepped ground, 400 steps walking at 0.3 m/s from step 100; a warm
# rollout, then a timed one from where it ended
TERRAIN_BATCH, TERRAIN_STEPS = 256, 400
TERRAIN_SCHEDULE = dict(mpc_qp_iters=25, mpc_solver_mode="fixed")
# the dual-rate schedule (tests/test_runtime.py's dual-rate test): 50
# fixed iterations, 2 s, the EKF at 500 Hz and control at 400 Hz,
# walking at 0.3 m/s from 1 s
DUAL_RATE = dict(seconds=2.0, walk_after_s=1.0)
DUAL_RATE_SCHEDULE = dict(mpc_qp_iters=50, mpc_solver_mode="fixed")
DUAL_RATE_STEPS = dict(est_steps=1000, ctrl_steps=800)
DUAL_RATE_Z = (0.2, 0.4)       # m, the height held
DUAL_RATE_MIN_X = 0.1          # m, walked forward
# phase 6g: the runtime and the CLI (tests/test_runtime.py, test_wire.py)
RUNNER = dict(mpc_iters=50, solver_mode="fixed")   # the runner's defaults
RUNNER_SECONDS = 1.0
RUNNER_EVERY = 2               # telemetry records: one in 2 ticks
RUNNER_Z = (0.1, 0.5)          # m, tests/test_runtime.py's smoke
WIRE_RUNS = (("native", 1.0, 10, 500, 400), ("sdk", 0.5, 5, 250, 200))
WIRE_Z = (0.2, 0.4)            # m, tests/test_wire.py
CLI = "a1_qp_mpc_controller_tpu_torch"
CLI_COMMANDS = {
    "sim": ["sim", "--seconds", "0.5", "--mpc-iters", "25",
            "--solver-mode", "fixed"],
    "realtime": ["realtime", "--seconds", "0.5", "--walk"],
    "batch": ["batch"],
    "golden": ["golden", "--seconds", "2", "--sample-every", "50"],
    "wire": ["wire", "--seconds", "0.5"],
}
# tests/test_runtime.py's refusals: a wall-clock profile for a simulated
# time executor and the converse
CLI_REFUSALS = {
    "sim_hardware_profile": ["sim", "--profile", "hardware_qp", "--seconds",
                             "0.01"],
    "wire_sim_profile": ["wire", "--profile", "gazebo_mpc", "--seconds",
                         "0.01"],
}
CLI_TIMEOUT_S = 300
# phase 6g also runs the articulated plant's command and the batch over two
# ranks (a launcher's processes sharing the one card, so gloo)
CLI_EXTRA = {
    "sim_joint": ["sim", "--plant", "joint", "--seconds", "0.5",
                  "--mpc-iters", "25", "--solver-mode", "fixed"],
    "batch_2_ranks": ["batch"],
}
# batch's defaults (__main__.py), for its blocks run in turn in this process
BATCH_DEFAULTS = dict(profile="gazebo_mpc", mpc_iters=50, velx=0.3, n=64,
                      steps=400, seed=0)
BATCH_RANKS = 2
BATCH_REL_TOL = 1e-6          # the two ranks' metrics vs the blocks in turn
TORCHRUN = ["-m", "torch.distributed.run", "--standalone",
            "--nproc-per-node", "2"]
# phase 6h: the articulated plant (tests/test_joint_plant.py,
# tests/test_torch_joint_plant.py)
JOINT_BATCH = 1024
JOINT_DT, JOINT_SUBSTEPS = 0.0025, 10
JOINT_F64_TOL = 1e-8          # every field, card (cuSOLVER) vs CPU (LAPACK)
# pose and velocities in float32: 1e-5 plus 1e-4 of the field's largest
# magnitude (tests/test_torch_joint_plant.py's limits; the velocities are
# a 30 x 30 solve's output, whose rounding scales with the largest one)
JOINT_F32_RTOL, JOINT_F32_ATOL = 1e-4, 1e-5
JOINT_FORCE_TOL = 1e-2        # N, the normal forces in float32
JOINT_ROLLOUTS = {            # tests/test_joint_plant.py:129, :142
    # heights held from 200 ticks into the walk (the trot's [600:])
    "trot": dict(profile="gazebo_mpc", n_steps=1400, walk_after=400,
                 velx=0.3, height=0.3),
    "isaac_onset": dict(profile="isaac_mpc", n_steps=900, walk_after=400,
                        velx=0.2, height=0.35),
}
JOINT_MPC_ITERS, JOINT_ROLLOUT_SUBSTEPS = 120, 5
JOINT_ROLLOUT_TIMEOUT_S = 600
TROT_MIN_X, TROT_Z = 0.4, (0.22, 0.40)
# phase 6i: the mesh
MESH_REL_TOL = 1e-6           # the ranks' reduced values vs one process's


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of ``fn()`` on the card, by CUDA events around
    ``reps`` calls after one warm-up call. The card first spins for
    ~10 ms, so that the host enqueues the calls ahead of it and a short
    kernel's time is its own, not the host's launch rate."""
    import torch
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(SPIN_CYCLES)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(flops: float, nbytes: float) -> tuple[float, str]:
    t_ops = flops / PEAK_F32_FLOPS
    t_bytes = nbytes / PEAK_BYTES_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


class Port:
    """The port's modules, imported once the repository is on the path."""

    def __init__(self):
        import importlib
        sys.path.insert(0, str(ROOT))
        for name in ("config", "types", "tensors", "control.grf",
                     "control.controller", "models.srb", "ops.qp",
                     "ops.kernels", "ops.kernels_retired",
                     "ops.kernels_scripts", "ops.linalg",
                     "parallel.batched", "sim.plant", "sim.closed_loop",
                     "sim.terrain", "runtime.components",
                     "runtime.profiling", "runtime.golden",
                     "runtime.realtime", "runtime.native",
                     "runtime.wire", "scripts.run_golden_dense",
                     "scripts.micro_admm", "sim.joint_plant",
                     "models.kinematics", "utils.mathx",
                     "parallel.mesh", "entry", "scripts.multihost_worker",
                     "scripts.probe_mosaic", "scripts.probe_mosaic2",
                     "scripts.probe_mosaic3", "scripts.probe_mosaic4"):
            setattr(self, name.split(".")[-1],
                    importlib.import_module(f"{PKG}.{name}"))


def setup(port, batch: int, device):
    import torch
    cfg, params = port.config.load_profile("gazebo_mpc", device=device)
    cfg = dataclasses.replace(cfg, **SCHEDULE)
    gen = torch.Generator().manual_seed(0)
    pb, terr, carry = port.batched.make_flat_batch(cfg, gen, batch, params,
                                                   device=device)
    joy_s = port.types.JoyCmd.zeros(device=device)
    joy_w = joy_s.replace(
        ctrl_state=torch.ones((), dtype=torch.int32, device=device),
        velx=torch.full((), 0.3, device=device))
    return cfg, pb, terr, carry, joy_s, joy_w


def warm(port, cfg, pb, terr, carry, joy_s, joy_w, device, stand, walk):
    for t in range(stand + walk):
        carry = port.batched.batched_closed_loop_step(
            cfg, pb, terr, carry, joy_s if t < stand else joy_w,
            cfg.control_dt, device=device, **GJ_KW)
    return carry


def real_tick(port, device):
    """The solver operands of one B = 1024 trot tick (after a short stand
    and trot warm-up), built by the port: the scaled KKT matrices at full
    size and at the reduced shapes, and each ADMM kernel's operands as a
    function of the inverse."""
    import torch
    qpx, srb, batched = port.qp, port.srb, port.batched
    cfg, pb, terr, carry, joy_s, joy_w = setup(port, BATCH, device)
    carry = warm(port, cfg, pb, terr, carry, joy_s, joy_w, device, 40, 40)
    dt = torch.full((), cfg.control_dt, device=device)
    sens = port.plant.read_sensors(pb, carry.ps, carry.prev_root_lin_vel, dt)
    cs, mem, prob = port.controller.control_tick_build(
        cfg, pb, carry.cs, carry.mem, sens, joy_w, dt, with_a_mat=True)
    scal = qpx.rescale_cost(prob.p_mat, prob.q_vec,
                            port.grf.scaling_for_contacts(
                                mem.mpc_scaling_table, cs.contacts))
    settings = qpx.QPSettings(rho=port.grf._MPC_RHO0, adaptive_rho=False)
    base, slope = srb.friction_basis_blocks(torch.float32, device)
    mu = pb.mu_mpc
    m_full = qpx.scaled_kkt_matrix_blockdiag(
        prob.p_mat, base, slope, mu, prob.lb, prob.ub, settings, prob.rho0,
        scal)
    a0, a1 = srb.friction_constraint_basis(cfg.horizon, torch.float32, device)
    # the reduced tier of 'reduced_admm' (22 blocks: 66 variables, 110
    # rows) and the live block of 'reduced' (64 variables)
    live_blk = srb.tile_last(cs.contacts, cfg.horizon)
    r = batched.gather_live_blocks(prob, scal, live_blk, 22)
    m_r = qpx.scaled_kkt_matrix_blockdiag(r.p, base, slope, mu, r.l, r.u,
                                          settings, prob.rho0, r.scal)
    a0r, a1r = srb.friction_constraint_basis_nblk(22, torch.float32, device)
    live = srb.tile_last(cs.contacts.repeat_interleave(3, dim=1),
                         cfg.horizon)
    m_64 = qpx.gather_square(m_full, qpx.live_first(live, 64)).contiguous()
    sp = qpx.apply_scaling(prob.p_mat, prob.q_vec, prob.a_mat, prob.lb,
                           prob.ub, scal)
    n_stance = cs.contacts.sum(dim=1)
    log(f"  real tick: stance legs per scenario "
        f"{ {int(k): int((n_stance == k).sum()) for k in range(5)} }, "
        f"{int(torch.isinf(prob.ub).sum())} unbounded constraint rows of "
        f"{prob.ub.numel()}")
    return dict(
        m_full=m_full, m_r=m_r.contiguous(), m_64=m_64,
        m_dense=qpx.scaled_kkt_matrix(prob.p_mat, prob.q_vec, prob.a_mat,
                                      prob.lb, prob.ub, settings, prob.rho0,
                                      scal),
        ops_full=lambda minv: qpx.shared_admm_operands(
            prob.q_vec, a0, a1, mu, prob.lb, prob.ub, settings,
            prob.warm_x, prob.warm_y, prob.rho0, scal, minv),
        ops_r=lambda minv: qpx.shared_admm_operands(
            r.q, a0r, a1r, mu, r.l, r.u, settings, r.warm_x, r.warm_y,
            prob.rho0, r.scal, minv),
        ops_legacy=lambda minv: qpx.legacy_admm_operands(
            sp, settings, prob.warm_x, prob.warm_y, prob.rho0, minv))


def gj_flops(n: int) -> int:
    """A Gauss-Jordan inverse's operations per matrix: a multiply and a
    subtract for each of the n + 1 columns of [M | I] per row and pivot
    that are not yet unit or zero columns (at pivot k, M's columns
    k..n-1 and the inverse's columns 0..k)."""
    return 2 * n * n * (n + 1)


def sweep_flops(n: int) -> int:
    """The sweep operator's: a multiply and a subtract per entry and
    pivot (one n x n array)."""
    return 2 * n ** 3


def inverse_rows(port, name, m_all, batches, fn, plain, flops=gj_flops,
                 resid_tol=K1_RESID_TOL, bits=False):
    """An inverse kernel (through ``fn``, (B, n, n) in and out) against
    its plain version on the first b matrices of ``m_all`` for each b:
    bit-equal (with ``bits``, compared as int32 views, so that signed
    zeros count), ||MX - I||_max within ``resid_tol`` (reported only where
    None); times of the kernel, the plain version, ``torch.linalg.inv``
    and the bound: each matrix read and written once, ``flops(n)``
    operations per matrix."""
    import torch
    rows = []
    for b in batches:
        m = m_all[:b].contiguous()
        x = fn(m)
        torch.cuda.synchronize()
        ref = plain(m)
        err = float((x - ref).abs().max())
        equal = bool(torch.equal(x.view(torch.int32), ref.view(torch.int32))
                     if bits else torch.equal(x, ref))
        n = m.shape[-1]
        eye = torch.eye(n, dtype=torch.float64, device=m.device)
        resid = float((m.double() @ x.double() - eye).abs().max())
        ms = cuda_ms(lambda: fn(m), 20)
        plain_ms = cuda_ms(lambda: plain(m), 3)
        lib_ms = cuda_ms(lambda: torch.linalg.inv(m), 10)
        bnd, by = bound_ms(b * flops(n), 2 * b * n * n * 4)
        log(f"  {name} B={b} n={n}: bit-equal {equal}"
            f"{' (int32 views)' if bits else ''} (max|kernel-plain| "
            f"{err:.3e}), ||MX-I||_max={resid:.3e} (tol {resid_tol}); "
            f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, torch.linalg.inv "
            f"{lib_ms:.4f} ms, bound {bnd:.4f} ms ({by})")
        if not (equal and (resid_tol is None or resid <= resid_tol)):
            raise AssertionError(f"{name} disagrees at B={b}, n={n}: "
                                 f"err {err}, resid {resid}")
        rows.append(dict(b=b, n=n, err=err, resid=resid, ms=ms,
                         plain_ms=plain_ms, lib_ms=lib_ms, bound_ms=bnd,
                         bound_by=by))
    return rows


def f32_products(port, m):
    """TF32 stays off on the products of the 'chol', hybrid and 'schur'
    inverses: the flags, and one of the hybrid's panel products (A21
    L11^-T shape) against float64. Returns its relative error."""
    import torch
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.get_float32_matmul_precision())
    if flags != (False, "highest"):
        raise AssertionError(f"TF32 is on for float32 products: {flags}")
    a, b = m[:, 30:, :30], m[:, :30, :30].transpose(1, 2)
    ref = a.double() @ b.double()
    rel = float(((a @ b).double() - ref).abs().max() / ref.abs().max())
    log(f"  float32 products: allow_tf32 {flags[0]}, precision {flags[1]!r}; "
        f"{tuple(a.shape)} @ {tuple(b.shape)} against float64: max rel "
        f"{rel:.3e} (tol {F32_PRODUCT_REL_TOL})")
    if rel > F32_PRODUCT_REL_TOL:
        raise AssertionError(f"float32 products are not exact: {rel}")
    return rel


def hybrid_panels(port, m):
    """``spd_cholesky_inverse_hybrid`` on the whole KKT batch, K5's
    launches counted from 0 just before it and read just after. Returns
    (the inverse, the launches, the panels it gave K5)."""
    import torch
    k, linalg = port.kernels, port.linalg
    panels = []
    launch = linalg.batched_chol_linv

    def record(a):
        panels.append(a.clone())
        return launch(a)

    linalg.batched_chol_linv = record
    try:
        k.reset_launches()
        hyb = linalg.spd_cholesky_inverse_hybrid(m)
        torch.cuda.synchronize()
        path_launches = k.launches[K5]
    finally:
        linalg.batched_chol_linv = launch
    if path_launches != len(panels) or not path_launches:
        raise AssertionError(f"K5 launched {path_launches} times for "
                             f"{len(panels)} panels")
    return hyb, path_launches, panels


def chol_rows(port, m):
    """The hybrid on the whole KKT batch, K5's launches counted (the
    panels it gives K5 kept); K5 against its plain version on the first
    and the last (trailing) panel and on the leading p x p blocks of the
    batch at ``K5_PS`` (both tiers), bit for bit; the hybrid held to
    ||MX - I||_max beside the 'chol' route's ``spd_cholesky_inverse``.
    Returns (K5 rows, the hybrid's K5 launches, the hybrid/chol
    record)."""
    import torch
    k, linalg = port.kernels, port.linalg
    hyb, path_launches, panels = hybrid_panels(port, m)
    cases = [("first", panels[0]), ("trailing", panels[-1])] + [
        (f"leading p={p}", m[:, :p, :p].contiguous()) for p in K5_PS]
    rows = []
    for label, a in cases:
        b, p, _ = a.shape
        x = k.batched_chol_linv(a)
        torch.cuda.synchronize()
        ref = k.batched_chol_linv_plain(a)
        equal = bool(torch.equal(x, ref))
        err = float((x - ref).abs().max())
        eye = torch.eye(p, dtype=a.dtype, device=a.device)
        ms = cuda_ms(lambda: k.batched_chol_linv(a), 20)
        plain_ms = cuda_ms(lambda: k.batched_chol_linv_plain(a), 3)
        lib_ms = cuda_ms(lambda: torch.linalg.solve_triangular(
            torch.linalg.cholesky(a), eye, upper=False), 10)
        # a Cholesky and a triangular inverse, p^3 / 3 operations each
        bnd, by = bound_ms(b * 2 * p ** 3 / 3, 2 * b * p * p * 4)
        tier = "registers" if p <= K5_REG_MAX else "shared memory"
        log(f"  K5 {label} panel B={b} p={p} ({tier}): bit-equal {equal} "
            f"(max|kernel-plain| {err:.3e}); kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, cholesky + solve_triangular {lib_ms:.4f} "
            f"ms, bound {bnd:.4f} ms ({by})")
        if not equal:
            raise AssertionError(f"K5 disagrees on the {label} panel: {err}")
        rows.append(dict(b=b, n=p, panel=label, tier=tier, err=err, ms=ms,
                         plain_ms=plain_ms, lib_ms=lib_ms, bound_ms=bnd,
                         bound_by=by))
    chol = linalg.spd_cholesky_inverse(m)
    resid_max = port.components.resid_max
    rec = dict(hybrid_resid=resid_max(m, hyb), chol_resid=resid_max(m, chol),
               rel_diff=float((hyb - chol).abs().max() / chol.abs().max()),
               hybrid_ms=cuda_ms(
                   lambda: linalg.spd_cholesky_inverse_hybrid(m), 5),
               chol_ms=cuda_ms(lambda: linalg.spd_cholesky_inverse(m), 3),
               k5_launches=path_launches)
    log(f"  spd_cholesky_inverse_hybrid B={m.shape[0]} n={m.shape[1]}: "
        f"{path_launches} K5 launches, ||MX-I||_max {rec['hybrid_resid']:.3e} "
        f"(tol {K1_RESID_TOL}); spd_cholesky_inverse ('chol') "
        f"{rec['chol_resid']:.3e}; max rel |hybrid-chol| "
        f"{rec['rel_diff']:.3e}; hybrid {rec['hybrid_ms']:.3f} ms, chol "
        f"{rec['chol_ms']:.3f} ms")
    if rec["hybrid_resid"] > K1_RESID_TOL:
        raise AssertionError(f"hybrid residual {rec['hybrid_resid']}")
    return rows, path_launches, rec


def block_inverse_row(port, m):
    """K6a (K3 at the base) against itself with K3's plain version at the
    base: the same NaN pattern, the finite entries within K6A_REL_TOL of
    their scale; its finite share (matrices with no NaN or inf),
    ||MX - I||_max over those, and the times."""
    import torch
    k, r = port.kernels, port.kernels_retired
    x = r.spd_block_inverse(m)
    torch.cuda.synchronize()
    base = k.batched_inverse_small
    k.batched_inverse_small = k.batched_inverse_small_plain
    try:
        ref = r.spd_block_inverse(m)
        plain_ms = cuda_ms(lambda: r.spd_block_inverse(m), 3)
    finally:
        k.batched_inverse_small = base
    same_nan = bool(torch.equal(torch.isnan(x), torch.isnan(ref)))
    fin = torch.isfinite(x) & torch.isfinite(ref)
    scale = float(ref[fin].abs().max()) if bool(fin.any()) else 1.0
    rel = float((x - ref)[fin].abs().max()) / scale if bool(fin.any()) else 0.0
    ok = torch.isfinite(x).flatten(1).all(dim=1)
    share = float(ok.float().mean())
    resid = (port.components.resid_max(m[ok], x[ok]) if bool(ok.any())
             else float("nan"))
    b, n, _ = m.shape
    ms = cuda_ms(lambda: r.spd_block_inverse(m), 10)
    lib_ms = cuda_ms(lambda: torch.linalg.inv(m), 10)
    bnd, by = bound_ms(b * gj_flops(n), 2 * b * n * n * 4)
    log(f"  K6a spd_block_inverse B={b} n={n}: same NaN pattern as with the "
        f"plain base {same_nan}, finite entries max rel {rel:.3e} (tol "
        f"{K6A_REL_TOL}); finite share {share:.5f}, ||MX-I||_max over the "
        f"finite {resid:.3e}; K3 base {ms:.4f} ms, plain base "
        f"{plain_ms:.4f} ms, torch.linalg.inv {lib_ms:.4f} ms, bound "
        f"{bnd:.4f} ms ({by})")
    if not (same_nan and rel <= K6A_REL_TOL):
        raise AssertionError(f"K6a with K3 differs from its plain base: "
                             f"NaN pattern {same_nan}, rel {rel}")
    return dict(b=b, n=n, rel=rel, finite_share=share, resid=resid, ms=ms,
                plain_ms=plain_ms, lib_ms=lib_ms, bound_ms=bnd, bound_by=by)


def admm_rows(port, name, ops_all, shapes, fn, plain, tol, flops_of,
              bytes_of, shared=(), dense_of=None):
    """A fused ADMM kernel against its plain version at each (b, iters),
    each output held to ``tol`` of its scale; times and the bound from
    ``flops_of(ops, iters)`` and ``bytes_of(ops)``; with ``dense_of``,
    the number of blocks that ran the dense order, read after the
    checked call."""
    import torch
    rows = []
    for b, iters in shapes:
        ops = {key: v if key in shared else v[:b].contiguous()
               for key, v in ops_all.items()}
        out = fn(**ops, iters=iters)
        torch.cuda.synchronize()
        dense = None if dense_of is None else dense_of()
        ref = plain(**ops, iters=iters, sigma=1e-6, alpha=1.6)
        err, rels = 0.0, []
        for o_name, o, r in zip("xyz", out, ref):
            if not bool(torch.isfinite(o).all()):
                raise AssertionError(f"{name} output {o_name} is not finite")
            e = float((o - r).abs().max())
            err = max(err, e)
            rels.append(e / float(r.abs().max()))
        ms = cuda_ms(lambda: fn(**ops, iters=iters), 10)
        plain_ms = cuda_ms(lambda: plain(**ops, iters=iters, sigma=1e-6,
                                         alpha=1.6), 3)
        n = ops["qs"].shape[1]
        m = ops["ls"].shape[1]
        flops, dense_flops = flops_of(ops, iters)
        bnd, by = bound_ms(flops, bytes_of(ops))
        log(f"  {name} B={b} n={n} m={m} iters={iters}: max rel "
            "|kernel-plain| x/y/z = " + "/".join(f"{r:.3e}" for r in rels)
            + f" (tol {tol}); kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"bound {bnd:.4f} ms ({by}; the dense count gives "
            f"{dense_flops / PEAK_F32_FLOPS * 1e3:.4f} ms)"
            + ("" if dense is None else
               f"; {dense} of {b} blocks ran the dense order"))
        if max(rels) > tol:
            raise AssertionError(f"{name} disagrees at B={b}, n={n}, "
                                 f"{iters} iterations: {rels}")
        rows.append(dict(b=b, n=n, m=m, iters=iters, err=err, rel=max(rels),
                         ms=ms, plain_ms=plain_ms, bound_ms=bnd,
                         bound_by=by))
        if dense is not None:
            rows[-1]["dense_blocks"] = dense
    return rows


def k2_flops(ops, iters):
    """Per iteration: the four A-products counted by the nonzeros of the
    shared A0/A1 (the data), the dense minv matvec, and the elementwise
    updates (~17 operations per row, 9 per variable); and the count
    with dense A-products. The function is float32's, so every operation
    is counted at float32's peak, the matvec too, though the kernel sums
    it in float64."""
    b, n = ops["qs"].shape
    m = ops["ls"].shape[1]
    nnz = int((ops["a0"] != 0).sum() + (ops["a1"] != 0).sum())
    return (b * iters * (4 * nnz + 2 * n * n + 17 * m + 9 * n),
            b * iters * (8 * m * n + 2 * n * n))


def k2_bytes(ops):
    """Inputs read once (minv, A0, A1, mu, three (B, n) and six (B, m)
    vectors), outputs written once (x, y, z)."""
    b, n = ops["qs"].shape
    m = ops["ls"].shape[1]
    return 4 * (b * n * n + 2 * m * n + b + 3 * b * n + 6 * b * m
                + b * n + 2 * b * m)


def k4_flops(ops, iters):
    """Per iteration: the two products with each scenario's A counted by
    its nonzeros (the data), the dense minv matvec and the elementwise
    updates (~9 operations per row, 6 per variable); and the count with
    dense A."""
    b, n = ops["qs"].shape
    m = ops["ls"].shape[1]
    nnz = int((ops["a_s"] != 0).sum())
    return (iters * (4 * nnz + b * (2 * n * n + 9 * m + 6 * n)),
            b * iters * (4 * m * n + 2 * n * n))


def k4_bytes(ops):
    """Inputs read once (minv, A, two (B, n) and five (B, m) vectors),
    outputs written once (x, y, z)."""
    b, n = ops["qs"].shape
    m = ops["ls"].shape[1]
    return 4 * (b * n * n + b * m * n + 2 * b * n + 5 * b * m
                + b * n + 2 * b * m)


def phase_kernels(port, device):
    import torch
    k = port.kernels
    tick = real_tick(port, device)
    out = {}
    log("[3a] K1 batched_inverse vs plain")
    out[K1] = inverse_rows(port, "K1", tick["m_full"],
                           (BATCH, 192, 160, 128, 96, 80, 48, 40)
                           + GATE_K1_BATCHES,
                           k.batched_inverse, k.batched_inverse_plain)
    log("[3b] K3 batched_inverse_small vs plain")
    out[K3] = (inverse_rows(port, "K3", tick["m_r"], (BATCH, 192, 48),
                            k.batched_inverse_small,
                            k.batched_inverse_small_plain)
               + inverse_rows(port, "K3", tick["m_64"], (BATCH,),
                              k.batched_inverse_small,
                              k.batched_inverse_small_plain)
               + inverse_rows(port, "K3 (K6a's base)",
                              tick["m_full"][:, :32, :32], (BATCH,),
                              k.batched_inverse_small,
                              k.batched_inverse_small_plain))
    log("[3c] K2 fused_admm_shared vs plain")
    ops_full = tick["ops_full"](k.batched_inverse(tick["m_full"]))
    ops_r = tick["ops_r"](k.batched_inverse_small(tick["m_r"]))
    run_k2 = lambda ops, shapes: admm_rows(
        port, "K2", ops, shapes, k.fused_admm_shared,
        k.fused_admm_shared_plain, K2_REL_TOL, k2_flops, k2_bytes,
        shared=("a0", "a1"))
    out[K2] = (run_k2(ops_full, ((BATCH, 25), (160, 25), (BATCH, 150),
                                 (192, 150), (96, 150), (80, 150),
                                 (48, 150), (40, 150)) + GATE_K2_SHAPES)
               + run_k2(ops_r, ((BATCH, 25), (192, 150), (48, 150))))
    log("[3d] K4 fused_admm vs plain")
    ops_l = tick["ops_legacy"](k.batched_inverse(tick["m_dense"]))
    # a dense random A in place of the friction pyramid: every block
    # overflows the kernel's nonzero lists and runs the dense order
    gen = torch.Generator().manual_seed(4)
    ops_o = {key: v[:K4_DENSE_BATCH].contiguous() for key, v in ops_l.items()}
    ops_o["a_s"] = (0.05 * torch.randn(ops_o["a_s"].shape, generator=gen)
                    ).to(device)
    run_k4 = lambda ops, shapes: admm_rows(
        port, "K4", ops, shapes, k.fused_admm, k.fused_admm_plain,
        K4_REL_TOL, k4_flops, k4_bytes,
        dense_of=lambda: int(k.paths["fused_admm"].sum()))
    out[K4] = (run_k4(ops_l, ((BATCH, 25),))
               + run_k4(ops_o, ((K4_DENSE_BATCH, 25),)))
    if (out[K4][0]["dense_blocks"] != 0
            or out[K4][1]["dense_blocks"] != K4_DENSE_BATCH):
        raise AssertionError("K4 took the wrong path: "
                             f"{[r['dense_blocks'] for r in out[K4]]}")
    m = tick["m_full"]
    log("[3e] float32 products")
    out["f32_product_rel"] = f32_products(port, m)
    log("[3f] K5 batched_chol_linv vs plain, the hybrid vs 'chol'")
    out[K5], out["k5_path_launches"], out["hybrid"] = chol_rows(port, m)
    log("[3g] K6g batched_inverse_T and the batch-last sweep vs plain")
    r = port.kernels_retired

    def batch_last(plain, **kw):
        return lambda x: plain(x.permute(1, 2, 0).contiguous(),
                               **kw).permute(2, 0, 1).contiguous()

    out[K6G] = inverse_rows(port, "K6g", m, (BATCH,), r.batched_inverse_T,
                            batch_last(r.gj_inverse_T_plain), resid_tol=None)
    out[K6S] = (
        inverse_rows(port, "sweep (K6j)", m, (BATCH,),
                     r.batched_inverse_sweep_T_masked,
                     batch_last(r.sweep_inverse_T_plain), flops=sweep_flops,
                     resid_tol=None)
        + inverse_rows(port, "sweep sym_col (K6h)", m, (BATCH,),
                       lambda x: r.batched_inverse_sweep_T(x, sym_col=True),
                       batch_last(r.sweep_inverse_T_plain, sym_col=True),
                       flops=sweep_flops, resid_tol=None))
    out["k6_designs"] = inverse_designs(port, m)
    log("[3h] K6a spd_block_inverse (K3 base)")
    out["k6a"] = block_inverse_row(port, m)
    log("[3i] K6b-K6f vs plain")
    out.update(retired_rows(port, m))
    return out


def inverse_designs(port, m, rounds: int = 2):
    """The kernels of ``csrc/inverse_t.cu``'s register tile under each
    rule set but K1's (K6g, the sweep, K6b, K6f: the sweep with
    ``sym_col``) beside ``torch.linalg.inv`` on the same batch, timed in
    turns within this call, ``rounds`` times; the mean ms of each over the
    rounds, and whether each ran faster than the library."""
    import torch
    r = port.kernels_retired
    fns = {"K6g": r.batched_inverse_T,
           "sweep (K6j)": r.batched_inverse_sweep_T_masked,
           "K6b": r.batched_inverse_inplace,
           "K6f": r.batched_inverse_spd,
           "torch.linalg.inv": torch.linalg.inv}
    times = {name: [] for name in fns}
    for _ in range(rounds):
        for name, fn in fns.items():
            times[name].append(cuda_ms(lambda: fn(m), 20))
    ms = {name: statistics.fmean(t) for name, t in times.items()}
    faster = {name: ms[name] < ms["torch.linalg.inv"]
              for name in fns if name != "torch.linalg.inv"}
    log(f"  at {tuple(m.shape)}, in turns: " + ", ".join(
        f"{name} {v:.4f} ms" for name, v in ms.items())
        + f"; below torch.linalg.inv: {faster}")
    return dict(ms=ms, below_library=faster)


def identity_bordered(m, n: int = 136, b: int = 64):
    """The first b matrices of ``m`` bordered by identity to n: a shape
    past the register tiles (n > 128), with the KKT block's values."""
    import torch
    big = torch.eye(n, device=m.device).repeat(b, 1, 1)
    big[:, :m.shape[1], :m.shape[2]] = m[:b]
    return big


def retired_rows(port, m):
    """K6b-K6f against their plain versions, bit for bit, at (1024, 120)
    on the KKT batch and at (64, 30), a leading block of it; K6d at ranks
    2 (the JAX default) and 4, K6e at 8 (its default) and 4, the ranks
    the component profile gives them, each at both shapes (n = 30 padded
    to 32 pivots at ranks 4 and 8); K6b and K6f also at (64, 136), past
    the register tile (``csrc/inverse_t.cu``'s device-memory kernel),
    compared as int32 views; ||MX - I||_max reported. Then K6d's and
    K6e's register tile beside ``torch.linalg.inv`` and the wide tier
    past the tile (``rank_designs``)."""
    r = port.kernels_retired
    small = m[:64, :30, :30].contiguous()
    big = identity_bordered(m)
    rank = lambda fn, k: (lambda x: fn(x, rank=k))
    cases = {
        K6B: [("K6b", r.batched_inverse_inplace,
               r.batched_inverse_inplace_plain)],
        K6C: [("K6c", r.batched_inverse_combined,
               r.batched_inverse_combined_plain)],
        K6D: [(f"K6d r={k}", rank(r.batched_inverse_rank, k),
               rank(r.batched_inverse_rank_plain, k)) for k in K6D_RANKS],
        K6E: [(f"K6e r={k}", rank(r.batched_inverse_rank_masked, k),
               rank(r.batched_inverse_rank_masked_plain, k))
              for k in K6E_RANKS],
        K6F: [("K6f", r.batched_inverse_spd, r.batched_inverse_spd_plain)],
    }
    out = {}
    for name, variants in cases.items():
        flops = sweep_flops if name == K6F else gj_flops
        one_array = name in (K6B, K6F)
        shapes = ((m, BATCH), (small, 64)) + (((big, 64),) if one_array
                                              else ())
        out[name] = []
        for label, fn, plain in variants:
            for x, b in shapes:
                out[name] += inverse_rows(port, label, x, (b,), fn, plain,
                                          flops=flops, resid_tol=None,
                                          bits=one_array)
    out["rank_designs"] = rank_designs(port, m)
    return out


def rank_designs(port, m, rounds: int = 2):
    """K6d and K6e at each profiled rank on the register tile beside
    ``torch.linalg.inv`` on the same batch, timed in turns within this
    call, ``rounds`` times (``tests/compare_source.py`` times the tile
    against the design it replaced); and at (64, 136), past the tile, the
    wide tier bit-equal to the plain version. The mean ms of each."""
    import torch
    r = port.kernels_retired
    fns = {}
    for label, entry, plain, ranks in (
            ("K6d", r.batched_inverse_rank, r.batched_inverse_rank_plain,
             K6D_RANKS),
            ("K6e", r.batched_inverse_rank_masked,
             r.batched_inverse_rank_masked_plain, K6E_RANKS)):
        for k in ranks:
            fns[f"{label} r={k} tile"] = (
                lambda e, k: lambda x: e(x, rank=k))(entry, k)
    fns["torch.linalg.inv"] = torch.linalg.inv
    # past the tile, the entry points run the wide tier: n = 136 (a
    # multiple of 2, 4 and 8), the KKT block bordered by identity
    big = identity_bordered(m)
    for label, entry, plain, ranks in (
            ("K6d", r.batched_inverse_rank, r.batched_inverse_rank_plain,
             K6D_RANKS),
            ("K6e", r.batched_inverse_rank_masked,
             r.batched_inverse_rank_masked_plain, K6E_RANKS)):
        for k in ranks:
            x = entry(big, rank=k)
            torch.cuda.synchronize()
            if not torch.equal(x, plain(big, rank=k)):
                raise AssertionError(f"{label} r={k} at (64, 136) differs "
                                     "from its plain version")
    times = {name: [] for name in fns}
    for _ in range(rounds):
        for name, fn in fns.items():
            times[name].append(cuda_ms(lambda: fn(m), 10))
    ms = {name: statistics.fmean(t) for name, t in times.items()}
    log(f"  K6d / K6e at {tuple(m.shape)}, the wide tier at (64, 136) "
        "bit-equal to the plain version; in turns: "
        + ", ".join(f"{name} {v:.4f} ms" for name, v in ms.items()))
    return dict(ms=ms)


def clone(port, tree):
    return port.tensors.tree_map(lambda a: a.clone(), tree)


def run_route(port, route, env, carry0, device):
    """One route's ticks at B = 1024 from a copy of the warmed state:
    the launch counts and the host reads from 0 just before them, read
    just after; then synchronizing calls and a profile over a few
    more ticks. Returns the route's metrics."""
    import torch
    batched, k, tensors = port.batched, port.kernels, port.tensors
    kw, n_warm, n_timed, needs = ROUTES[route]
    cfg, pb, terr, joy = env
    carry = clone(port, carry0)
    kc = [batched.make_kkt_carry(cfg, BATCH, device=device)
          if route == "amortized" else None]

    def step(carry):
        extra = dict(kkt_carry=kc[0]) if kc[0] is not None else {}
        out = batched.batched_closed_loop_step(
            cfg, pb, terr, carry, joy, cfg.control_dt, device=device,
            return_stats=True, **extra, **kw)
        if kc[0] is not None:
            carry, kc[0], stats = out
        else:
            carry, stats = out
        return carry, stats

    flips = torch.zeros((), dtype=torch.int64, device=device)
    k.reset_launches()
    tensors.host_syncs = 0
    for _ in range(n_warm):
        prev = carry.cs.contacts
        carry, _ = step(carry)
        flips += (carry.cs.contacts != prev).any(dim=1).sum()
    torch.cuda.synchronize()
    syncs0 = tensors.host_syncs
    conv = []
    events = [torch.cuda.Event(enable_timing=True)
              for _ in range(n_timed + 1)]
    t0 = time.perf_counter()
    events[0].record()
    for i in range(n_timed):
        prev = carry.cs.contacts
        carry, stats = step(carry)
        events[i + 1].record()
        conv.append(stats["converged"])
        flips += (carry.cs.contacts != prev).any(dim=1).sum()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(k.launches)
    reads = (tensors.host_syncs - syncs0) / n_timed
    # every synchronizing call the card sees in a few more ticks (the
    # counter above counts only the branches written as host reads)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            for _ in range(3):
                carry, _ = step(carry)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    synced = len(caught) / 3
    sites = {}
    for w in caught:
        site = f"{Path(w.filename).name}:{w.lineno}"
        sites[site] = sites.get(site, 0) + 1
    log(f"  {route}: synchronizing call sites over 3 ticks: " + ", ".join(
        f"{s} x{v}" for s, v in sorted(sites.items(), key=lambda kv: -kv[1])))
    prof = profile_ticks(port, route, step, carry)
    tick_ms = [events[i].elapsed_time(events[i + 1]) for i in range(n_timed)]
    conv_frac = float(torch.stack(conv).float().mean())
    z = carry.ps.root_pos[:, 2]
    alive = float((~torch.isnan(z)).float().mean())
    ms_sorted = sorted(tick_ms)
    metrics = dict(
        ticks=n_timed, solves_per_s=BATCH * n_timed / wall,
        tick_ms_mean=sum(tick_ms) / len(tick_ms),
        tick_ms_p50=ms_sorted[len(ms_sorted) // 2],
        tick_ms_p99=ms_sorted[int(0.99 * (len(ms_sorted) - 1))],
        alive=alive, converged=conv_frac, host_reads_per_tick=reads,
        synchronizing_calls_per_tick=synced, flips=int(flips),
        mean_z=float(torch.nanmean(z)), launches=counts, profile=prof)
    if kc[0] is not None:
        metrics["kkt_age_max"] = int(kc[0].age.max())
    log(f"  {route} B={BATCH}: {n_warm} untimed + {n_timed} timed ticks: "
        f"{metrics['solves_per_s']:.1f} solves/s, tick mean "
        f"{metrics['tick_ms_mean']:.3f} ms p50 {metrics['tick_ms_p50']:.3f} "
        f"p99 {metrics['tick_ms_p99']:.3f}; alive {alive}, converged "
        f"{conv_frac}, host reads/tick {reads} (synchronizing calls/tick "
        f"{synced}), contact flips {metrics['flips']}, mean z "
        f"{metrics['mean_z']:.4f} m; launches {counts}")
    if alive != 1.0 and route not in UNHELD_ALIVE:
        raise AssertionError(f"{route}: alive {alive}")
    if route in CONVERGED_ROUTES and conv_frac < CONVERGED_MIN:
        raise AssertionError(f"{route}: converged {conv_frac}")
    if not all(counts[name] > 0 for name in needs):
        raise AssertionError(f"a kernel of {sorted(needs)} never launched "
                             f"on the {route} route: {counts}")
    if metrics["flips"] == 0:
        raise AssertionError(f"no contact flips on the {route} route")
    return metrics


def phase_routes(port, device):
    """The 'gj' warm-up once; then, each from a copy of it, every route,
    ``control_tick`` in both modes and the component profile."""
    import torch
    k = port.kernels
    t0 = time.perf_counter()
    cfg, pb, terr, carry, joy_s, joy_w = setup(port, BATCH, device)
    k.reset_launches()
    carry = warm(port, cfg, pb, terr, carry, joy_s, joy_w, device,
                 STAND_TICKS, WALK_TICKS)
    torch.cuda.synchronize()
    gj_counts = dict(k.launches)
    warm_s = time.perf_counter() - t0
    log(f"  warm-up: {STAND_TICKS}+{WALK_TICKS} 'gj' ticks in {warm_s:.1f} "
        f"s, launches {gj_counts}")
    if not (gj_counts[K1] and gj_counts[K2]):
        raise AssertionError(f"a kernel never launched on 'gj': {gj_counts}")
    env = (cfg, pb, terr, joy_w)
    routes = {name: run_route(port, name, env, carry, device)
              for name in ROUTES}
    for base, names in (("gj", LIKE_GJ), ("pallas", LIKE_LEGACY)):
        ref = routes[base]["converged"]
        for name in names:
            conv = routes[name]["converged"]
            log(f"  {name}: converged {conv} against {base!r} {ref} (at "
                f"most {CONVERGED_GAP} below)")
            if conv < ref - CONVERGED_GAP:
                raise AssertionError(f"{name}: converged {conv}, {base!r} "
                                     f"{ref}")
    log("[4b] control_tick over the batch")
    ticks = control_ticks(port, env, carry, device)
    log("[4c] component profile")
    profile = phase_components(port, env, carry, device)
    return routes, gj_counts, warm_s, ticks, profile


def control_step(port, cfg, pb, terr, carry, joy):
    """One closed-loop tick through ``control_tick`` over the batch:
    the sensors, the tick, the plant."""
    import torch
    dt = torch.full((), cfg.control_dt, device=carry.ps.root_pos.device)
    sens = port.plant.read_sensors(pb, carry.ps, carry.prev_root_lin_vel, dt)
    cs, mem, tq = port.controller.control_tick(cfg, pb, carry.cs, carry.mem,
                                               sens, joy, dt)
    ps = port.plant.plant_step(pb, terr, carry.ps, tq, dt, 5)
    return port.closed_loop.LoopCarry(cs=cs, mem=mem, ps=ps,
                                      prev_root_lin_vel=carry.ps.root_lin_vel)


def control_ticks(port, env, carry0, device, ticks: int = 3,
                  modes=CONTROL_TICK_MODES, label: str = ""):
    """``control_tick`` over the batch (its own solve, as the JAX package
    runs it under ``vmap``) for a few closed-loop ticks from a copy of
    the warmed state, in each of ``modes`` (config overrides): tick
    times, the adaptive loop's host reads, alive and finite torques."""
    import torch
    cfg, pb, terr, joy = env
    b = carry0.ps.root_pos.shape[0]
    out = {}
    for mode, kw in modes.items():
        c_cfg = dataclasses.replace(cfg, **kw)
        carry = clone(port, carry0)
        port.tensors.host_syncs = 0
        ms = []
        for _ in range(ticks):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            carry = control_step(port, c_cfg, pb, terr, carry, joy)
            end.record()
            end.synchronize()
            ms.append(start.elapsed_time(end))
        reads = port.tensors.host_syncs / ticks
        alive = float((~torch.isnan(carry.ps.root_pos[:, 2])).float().mean())
        finite = bool(torch.isfinite(carry.cs.joint_torques).all())
        out[mode] = dict(tick_ms=ms, host_reads_per_tick=reads, alive=alive)
        log(f"  {label}control_tick {mode} B={b}: {ticks} closed-loop "
            f"ticks {', '.join(f'{t:.3f}' for t in ms)} ms; host reads/tick "
            f"{reads}; alive {alive}, torques finite {finite}")
        if alive != 1.0 or not finite:
            raise AssertionError(f"control_tick {mode}: alive {alive}, "
                                 f"finite {finite}")
    return out


def phase_components(port, env, carry, device):
    """The component profile (``runtime.components``) at B = 1024 on the
    warmed state, the launch counts set to 0 just before it and read just
    after: every kernel it times must have launched."""
    import torch
    cfg, pb, terr, joy = env
    k = port.kernels
    dt = torch.full((), cfg.control_dt, device=device)
    sens = port.plant.read_sensors(pb, carry.ps, carry.prev_root_lin_vel, dt)
    k.reset_launches()
    rows = port.components.components(cfg, pb, carry.cs, carry.mem, sens,
                                      joy, dt, printer=lambda t: log("  " + t))
    torch.cuda.synchronize()
    counts = dict(k.launches)
    log(f"  component profile launches: {counts}")
    if not all(counts[name] > 0 for name in PROFILE_KERNELS):
        raise AssertionError(f"a kernel of the profile never launched: "
                             f"{counts}")
    return dict(rows=rows, launches=counts)


def profile_ticks(port, route, step, carry, ticks: int = 5):
    """Kernel time by name over a few ticks (torch.profiler's CUDA kernel
    events, which do not overlap on the one stream, through
    ``runtime.profiling.trace``; the trace goes to ``TRACE_DIR/<route>``),
    the kernel launches per tick, and the share of the wall time the
    card was busy."""
    import torch
    from torch.autograd import DeviceType
    torch.cuda.synchronize()
    with port.profiling.trace(str(TRACE_DIR / route)) as prof:
        t0 = time.perf_counter()
        for _ in range(ticks):
            carry, _ = step(carry)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA),
                  key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    if busy <= 0:
        log(f"  {route} profile: no device time recorded (not measured)")
        return None
    launches = sum(r[2] for r in rows) / ticks
    log(f"  {route} profile over {ticks} ticks: wall "
        f"{wall_ms / ticks:.3f} ms/tick, kernel time {busy / ticks:.3f} "
        f"ms/tick ({100 * busy / wall_ms:.1f}% of wall), {launches:.1f} "
        f"kernel launches/tick")
    for key, ms, count in rows[:8]:
        log(f"    {ms / ticks:9.3f} ms/tick  x{count / ticks:6.1f}  {key[:90]}")
    named = {}
    for key, ms, count in rows:
        for label, parts in NAMED_KERNELS.items():
            if any(part in key for part in parts):
                k_ms, k_count = named.get(label, (0.0, 0.0))
                named[label] = (k_ms + ms / ticks, k_count + count / ticks)
    for label, (ms, count) in named.items():
        log(f"    {label}: {ms:.4f} ms/tick x{count:.1f}")
    return dict(wall_ms=wall_ms / ticks, kernel_ms=busy / ticks,
                busy_share=busy / wall_ms, launches=launches,
                named_kernels=named,
                top=[(key[:60], ms / ticks) for key, ms, _ in rows[:4]])


def small_start(port, device):
    """The small batch stood up for 20 ticks on the CPU, and the tick's
    fixed arguments on the card and on the CPU: (cfg, carry, env)."""
    import torch
    cpu = torch.device("cpu")
    cfg, pb, terr, carry, joy_s, joy_w = setup(port, SMALL_BATCH, cpu)
    carry = warm(port, cfg, pb, terr, carry, joy_s, joy_w, cpu, 20, 0)
    env = {dev: (to_device(port, pb, dev), to_device(port, terr, dev),
                 to_device(port, joy_w, dev)) for dev in (device, cpu)}
    return cfg, carry, env


def to_device(port, tree, dev):
    return port.tensors.tree_map(lambda a: a.to(dev), tree)


def small_diff(route, tick, card, host) -> dict:
    """One small tick's card-vs-CPU distances (``SMALL_LIMITS``' keys);
    raises if the card's torques are not finite or a discrete leaf of
    the carried state or the contacts differ."""
    import torch
    diff = lambda a, b: float((a.cpu() - b.cpu()).abs().max())
    if not bool(torch.isfinite(card.cs.joint_torques).all()):
        raise AssertionError(f"small {route}: torques not finite")
    for name in SMALL_EXACT:
        if not torch.equal(getattr(card.mem, name).cpu(),
                           getattr(host.mem, name).cpu()):
            raise AssertionError(f"small {route} tick {tick}: {name} "
                                 "differs")
    if not torch.equal(card.cs.contacts.cpu(), host.cs.contacts.cpu()):
        raise AssertionError(f"small {route} tick {tick}: contacts differ")
    ratio = card.mem.mpc_rho.cpu() / host.mem.mpc_rho.cpu()
    return dict(
        torque=diff(card.cs.joint_torques, host.cs.joint_torques),
        force=diff(card.cs.foot_forces_grf, host.cs.foot_forces_grf),
        warm_x=diff(card.mem.mpc_warm_x, host.mem.mpc_warm_x),
        warm_y_rel=diff(card.mem.mpc_warm_y, host.mem.mpc_warm_y)
        / float(host.mem.mpc_warm_y.abs().max()),
        rho_factor=float(torch.maximum(ratio, 1.0 / ratio).max()))


def small_verdict(route, got, note=""):
    log(f"  small B={SMALL_BATCH} {route}{note}: card vs CPU max |d| "
        + ", ".join(f"{key} {v:.3e} (tol {SMALL_LIMITS[key]})"
                    for key, v in got.items())
        + f"; {', '.join(SMALL_EXACT)} and contacts equal")
    if any(v > SMALL_LIMITS[key] for key, v in got.items()):
        raise AssertionError(f"small {route}{note}: {got}")


def phase_small(port, device):
    """A small batch stood up for 20 ticks on the CPU, then copied to the
    card: 3 trot ticks on each route there (CUDA kernels) and on the CPU
    (plain versions), compared tick by tick (torques, forces, contacts
    and the carried controller state); from that one state, or, on the
    routes that say so, each CPU tick from the card's state before
    it. Then 'full' free-running (``small_full_free``)."""
    import torch
    cpu = torch.device("cpu")
    cfg, carry, env = small_start(port, device)
    worst = {}
    for route, (kw, synced) in SMALL_ROUTES.items():
        def step(dev, c, kc):
            p, tr, jw = env[dev]
            if route.startswith("control_tick"):
                return control_step(port, dataclasses.replace(cfg, **kw), p,
                                    tr, c, jw), kc
            if route == "amortized":
                return port.batched.batched_closed_loop_step(
                    cfg, p, tr, c, jw, cfg.control_dt, device=dev,
                    kkt_carry=kc, **kw)
            return port.batched.batched_closed_loop_step(
                cfg, p, tr, c, jw, cfg.control_dt, device=dev, **kw), kc

        state = {dev: (to_device(port, carry, dev),
                       port.batched.make_kkt_carry(cfg, SMALL_BATCH,
                                                   device=dev))
                 for dev in (device, cpu)}
        got = dict.fromkeys(SMALL_LIMITS, 0.0)
        for tick in range(3):
            if synced:
                state[cpu] = (to_device(port, state[device][0], cpu),
                              state[cpu][1])
            state = {dev: step(dev, *state[dev]) for dev in state}
            now = small_diff(route, tick, state[device][0], state[cpu][0])
            got = {key: max(v, now[key]) for key, v in got.items()}
        small_verdict(route, got, " (tick by tick)" if synced else "")
        worst[route] = got
    worst["full_free"] = small_full_free(port, device, cfg, carry, env)
    return worst


def _k2_iterations(xt_of):
    """K2's plain iterations (``kernels.fused_admm_shared_plain``) with
    the x-update minv' rhs computed by ``xt_of(minv, rhs)``."""
    import torch

    def run(a0, a1, minv, mu, d, e, qs, ls, us, rho_vec, x0, y0, z0, *,
            iters, sigma, alpha):
        me = mu[:, None] * e
        inv_rho = 1.0 / rho_vec
        x, y, z = x0, y0, z0
        for _ in range(iters):
            w = rho_vec * z - y
            atw = (e * w) @ a0 + (me * w) @ a1
            rhs = sigma * x - qs + d * atw
            xt = xt_of(minv, rhs)
            x1 = alpha * xt + (1.0 - alpha) * x
            xd = d * xt
            ax = e * (xd @ a0.T) + me * (xd @ a1.T)
            zp = alpha * ax + (1.0 - alpha) * z
            z1 = torch.clamp(zp + y * inv_rho, ls, us)
            y = y + rho_vec * (zp - z1)
            x, z = x1, z1
        return x, y, z
    return run


def f64_xt(minv, rhs):
    """minv' rhs as K2 sums it (csrc/fused_admm_shared.cu): in float64
    (each float32 product exact), rounded once to float32. The kernel
    sums a column's slices in a fixed order, which moves the float64 sum
    by rounding errors of 2^-53 that the final rounding to float32 hides
    except next to a tie."""
    import torch
    return torch.einsum("bij,bi->bj", minv.double(), rhs.double()).float()


def k2_cpu_ways(plain):
    """The ways the free-running witness runs K2's plain version on the
    CPU: as it is (one float32 chain a column), with the x-update summed
    as the kernel sums it, and every iteration in float64 (inputs
    widened, outputs rounded once)."""
    import torch
    return {
        "plain": plain,
        "xt64": _k2_iterations(f64_xt),
        "k64": lambda *args, **kw: tuple(o.float() for o in plain(
            *(a.double() if torch.is_tensor(a) else a for a in args),
            **{k: v.double() if torch.is_tensor(v) else v
               for k, v in kw.items()})),
    }


def small_full_free(port, device, cfg, carry, env):
    """'full' free-running for 3 ticks from the small batch's state: on
    the card, and on the CPU with K2's plain version each way of
    ``k2_cpu_ways``. The card must stay within the small limits of the
    CPU that sums the x-update as K2 does ('xt64'), and nearer the float64
    iterations ('k64') in torques and forces than the plain float32 CPU
    is: so the drift between the card and the plain CPU is the plain
    chain's rounding, not K2's."""
    import torch
    cpu = torch.device("cpu")
    k = port.kernels
    plain = k.fused_admm_shared_plain

    def run(dev, way=None):
        p, tr, jw = env[dev]
        c = to_device(port, carry, dev)
        out = []
        if way is not None:
            k.fused_admm_shared_plain = k2_cpu_ways(plain)[way]
        try:
            for _ in range(3):
                c = port.batched.batched_closed_loop_step(
                    cfg, p, tr, c, jw, cfg.control_dt, device=dev, **FULL_KW)
                out.append(to_device(port, c, cpu))
        finally:
            k.fused_admm_shared_plain = plain
        return out

    runs = {"card": run(device)}
    runs.update({way: run(cpu, way) for way in ("plain", "xt64", "k64")})
    pairs = {}
    for a, b in (("card", "xt64"), ("card", "plain"), ("card", "k64"),
                 ("plain", "k64"), ("xt64", "k64")):
        got = dict.fromkeys(SMALL_LIMITS, 0.0)
        for tick, (x, y) in enumerate(zip(runs[a], runs[b])):
            try:
                now = small_diff(f"full {a} vs {b}", tick, x, y)
            except AssertionError as err:
                if (a, b) == ("card", "xt64"):
                    raise
                log(f"  small full free {a} vs {b}: {err}")
                now = dict.fromkeys(SMALL_LIMITS, float("inf"))
            got = {key: max(v, now[key]) for key, v in got.items()}
        pairs[f"{a} vs {b}"] = got
        if (a, b) != ("card", "xt64"):
            log(f"  small B={SMALL_BATCH} full free, {a} vs {b}: max |d| "
                + ", ".join(f"{key} {v:.3e}" for key, v in got.items()))
    small_verdict("full", pairs["card vs xt64"],
                  " (free, the CPU's x-update summed in float64 as K2's)")
    nearer = {key: (pairs["card vs k64"][key], pairs["plain vs k64"][key])
              for key in ("torque", "force")}
    log(f"  small B={SMALL_BATCH} full free, from K2's iterations in "
        "float64, the card / the plain float32 CPU: "
        + ", ".join(f"{key} {a:.3e} / {b:.3e}"
                    for key, (a, b) in nearer.items()))
    if any(a >= b for a, b in nearer.values()):
        raise AssertionError(f"small full free: the card is not nearer K2's "
                             f"float64 iterations than the plain CPU: "
                             f"{nearer}")
    return pairs


# --- 5: the scripts' kernels (S1, S2) and paths ---------------------------

def s1_flops(variant: str, b: int, iters: int) -> int:
    """S1's operations: the two M x N products unless 'nomatmul', the
    N x N matvec unless 'nominv', and the elementwise updates (~13 a row,
    ~6 a variable) per iteration and scenario."""
    n, m = 128, 256
    mats = 0 if variant == "nomatmul" else 4 * m * n
    minv = 0 if variant == "nominv" else 2 * n * n
    return b * iters * (mats + minv + 13 * m + 6 * n)


def s1_bytes(variant: str, b: int) -> int:
    """Inputs read once (a0 unless 'nomatmul', minv unless 'nominv',
    six (B, M) and two (B, N) vectors), outputs written once."""
    n, m = 128, 256
    a0 = 0 if variant == "nomatmul" else m * n
    minv = 0 if variant == "nominv" else b * n * n
    return 4 * (a0 + minv + 6 * b * m + 2 * b * n + b * n + 2 * b * m)


def s1_rows(port, device, scripts):
    """S1's rows from ``scripts.micro_admm``'s run in ``phase_scripts``
    (B = 1024, every variant and unroll: its time at 50 iterations and
    its check, 3 iterations on every scenario, the script's 50 on the
    float32-stable ones, 'nominv' diverged in both, the unrolls
    bit-equal), with the plain version's time and the bound."""
    ks, ma = port.kernels_scripts, port.micro_admm
    ins = ma.make_inputs(BATCH, device)
    result = scripts["micro_admm"]["result"]
    rows = []
    for variant in ks.VARIANTS:
        plain_ms = cuda_ms(lambda: ks.micro_admm_plain(**ins, variant=variant),
                           3)
        bnd, by = bound_ms(s1_flops(variant, BATCH, ks.ITERS),
                           s1_bytes(variant, BATCH))
        for unroll in ks.UNROLLS:
            r = result[f"{variant} unroll={unroll}"]
            res, ms = r["check"], r["ms"]
            sh, full = res["short"], res["full"]
            log(f"  S1 {variant} unroll={unroll} B={BATCH}: "
                f"{ma.SHORT_ITERS} it max rel |kernel-plain| "
                f"{sh['max_rel']:.3e} on every scenario; "
                + (f"{ks.ITERS} it both diverged {full['diverged']}"
                   if variant == "nominv" else
                   f"{ks.ITERS} it {full['held']}/{BATCH} float32-stable "
                   f"scenarios held, max rel {full['max_rel_held']:.3e} "
                   f"(all scenarios {full['max_rel']:.3e})")
                + f" (tol {ma.TOL}); equal to unroll 1 "
                f"{res['unrolls_equal']}; kernel {ms:.4f} ms, plain "
                f"{plain_ms:.4f} ms, bound {bnd:.4f} ms ({by})")
            rows.append(dict(variant=variant, unroll=unroll, b=BATCH,
                             n=ks.N, m=ks.M, iters=ks.ITERS,
                             err=sh["max_abs"], ms=ms, plain_ms=plain_ms,
                             lib_ms=None, bound_ms=bnd, bound_by=by,
                             check=res))
    return rows


def s2_flops(body: str, shape, n: int) -> int:
    """A probe's operations: the multiplies, subtracts and adds its
    function needs, a value shared by a row, a column or a step formed
    once (negate: one a value; dyn_store's 2 m[0] and slab_axis0's
    0 + m[n-1] once a lane; carry_const's 1e-6 r and r + 1 once a step;
    rank1 and thin_transpose round each product before its scaling, 3 an
    entry a step)."""
    ni, nj, s = shape
    if body == "negate":
        return ni * nj * s
    if body in ("dyn_store", "slab_axis0"):
        return s * nj * min(n, 1)
    if body == "carry_const":
        return n * (s * ni * nj + 2)
    per_step = {"fori_mask": ni, "dyn_read": 0,
                "axis1_reduce": ni * nj + ni, "axis0_reduce": ni * nj + nj,
                "carry_vec": ni * nj + nj, "rank1": 3 * ni * nj,
                "thin_transpose": 3 * ni * nj}
    return s * n * per_step[body]


def s2_library(body: str, m, n: int):
    """The one PyTorch call that computes the probe, where there is one:
    ``torch.neg`` for negate, ``m * 2`` for the mask select over every
    column."""
    if body == "negate":
        return lambda: m.neg()
    if body == "fori_mask" and n == m.shape[1]:
        return lambda: m * 2
    return None


# the elementwise bodies' shapes: the ladders' two and the grid negate's
S2_TURN_SHAPES = ((8, 8, 128), (120, 120, 128), (120, 120, 1024))
S2_LIBRARY_LIMIT = 1.05   # a body's time over its library call's, in turns


def s2_in_turns(port, device, rounds: int = 2):
    """Each S2 body that has a library call (negate, and fori_mask over
    every column) against that call on the same seeded input, at every
    shape of ``S2_TURN_SHAPES``: bit for bit against its plain version,
    then the kernel and the call timed in turns (kernel, call, call,
    kernel, ``rounds`` times), each by ``cuda_ms``. Returns
    {(body, shape): dict(ms, lib_ms, ratio)}; a ratio above
    S2_LIBRARY_LIMIT is logged, not raised."""
    import torch
    ks = port.kernels_scripts
    g = torch.Generator().manual_seed(1)
    out = {}
    for shape in S2_TURN_SHAPES:
        m = torch.randn(shape, generator=g).to(device)
        for body in ("negate", "fori_mask"):
            n = shape[1] if body == "fori_mask" else 0
            x = ks.mosaic_probe(body, m, n)
            torch.cuda.synchronize()
            if not torch.equal(x, ks.mosaic_probe_plain(body, m, n)):
                raise AssertionError(f"S2 {body} {shape} differs from its "
                                     "plain version")
            fns = {"kernel": lambda: ks.mosaic_probe(body, m, n),
                   "library": s2_library(body, m, n)}
            times = {key: [] for key in fns}
            for _ in range(rounds):
                for key in ("kernel", "library", "library", "kernel"):
                    times[key].append(cuda_ms(fns[key], 20))
            ms, lib_ms = (statistics.fmean(times[key])
                          for key in ("kernel", "library"))
            out[(body, tuple(shape))] = dict(ms=ms, lib_ms=lib_ms,
                                             ratio=ms / lib_ms)
            over = "" if ms / lib_ms <= S2_LIBRARY_LIMIT else ", over"
            log(f"  S2 {body} {shape} in turns: kernel {ms:.4f} ms, "
                f"library {lib_ms:.4f} ms, ratio {ms / lib_ms:.3f} (limit "
                f"{S2_LIBRARY_LIMIT}{over}); bit-equal True")
    return out


# besides the ladders' shapes, each body is held at these (ni != nj, tiles
# that pad, odd lane counts; past them the chains' 1,024 entries and the
# tile's 128 rows or columns: the shared-memory tier), at the steps of
# ``s2_steps``; tests/test_torch_probe_packing.py holds its models and
# the kernel at the same shapes and steps
S2_ODD_SHAPES = ((24, 40, 1), (40, 24, 3), (24, 24, 128), (120, 8, 3),
                 (8, 120, 3), (5, 7, 9), (120, 120, 3), (1100, 2, 3),
                 (2, 1100, 3), (136, 130, 2), (130, 130, 3))


def s2_steps(ks, body: str, shape) -> list[int]:
    """The steps a probe body is held at on ``shape``: n = 0, 1, the most
    that every row and column it indexes allows, and one below half of
    it (negate takes none)."""
    ni, nj, _ = shape
    top = 0 if body == "negate" else min(
        ni if body in ks._ROW_STEPS else nj,
        nj if body in ks._COL_STEPS else ni)
    return sorted({0, min(1, top), top, top // 2 - 1} - {-1})


def s2_odd(port, device) -> int:
    """Every S2 body at ``S2_ODD_SHAPES`` on a seeded random input, bit
    for bit against its plain version; returns the cases held."""
    import torch
    ks = port.kernels_scripts
    g = torch.Generator().manual_seed(2)
    held = 0
    for shape in S2_ODD_SHAPES:
        ni, nj, _ = shape
        m = torch.randn(shape, generator=g).to(device)
        for body in ks.BODIES:
            if body == "thin_transpose" and ni != nj:
                continue
            for n in s2_steps(ks, body, shape):
                x = ks.mosaic_probe(body, m, n)
                torch.cuda.synchronize()
                if not torch.equal(x, ks.mosaic_probe_plain(body, m, n)):
                    raise AssertionError(f"S2 {body} {shape} n={n} differs "
                                         "from its plain version")
                held += 1
    log(f"  S2 at the odd shapes: {held} cases bit-equal")
    return held


def s2_rows(port, device, scripts):
    """S2's rows: every probe of the three ladders at its shape, its time
    from the ladder's run in ``phase_scripts``; here on seeded random
    inputs (ones hide transposes) bit for bit against its plain version,
    the plain version's and the library call's times, the bound (the
    array read and written once, or its operations). Where a body has a
    library call, its ``ms`` and ``lib_ms`` are the pair timed in turns
    (``s2_in_turns``), the ladder's own time kept as ``ladder_ms``."""
    import torch
    ks = port.kernels_scripts
    turns = s2_in_turns(port, device)
    g = torch.Generator().manual_seed(0)
    ladders = (("probe_mosaic", port.probe_mosaic.LADDER),
               ("probe_mosaic2", port.probe_mosaic2.LADDER),
               ("probe_mosaic4", (("grid negate", "negate",
                                   port.probe_mosaic4.GRID_SHAPE, 0),)))
    timed = {r["name"]: r["ms"]
             for ladder in ("probe_mosaic", "probe_mosaic2")
             for r in scripts[ladder]["result"]}
    timed["grid negate"] = scripts["probe_mosaic4"]["result"][
        "grid negate"]["ms"]
    out = {}
    for ladder, rungs in ladders:
        rows = out[ladder] = []
        for name, body, shape, n in rungs:
            m = torch.randn(shape, generator=g).to(device)
            x = ks.mosaic_probe(body, m, n)
            torch.cuda.synchronize()
            ref = ks.mosaic_probe_plain(body, m, n)
            equal = bool(torch.equal(x, ref))
            err = float((x - ref).abs().max())
            ms = ladder_ms = timed[name]
            plain_ms = cuda_ms(lambda: ks.mosaic_probe_plain(body, m, n), 3)
            lib_ms = None
            if s2_library(body, m, n) is not None:
                pair = turns[(body, tuple(shape))]
                ms, lib_ms = pair["ms"], pair["lib_ms"]
            bnd, by = bound_ms(s2_flops(body, shape, n), 2 * m.numel() * 4)
            log(f"  S2 {ladder}: {name} ({body}, {n} steps): bit-equal "
                f"{equal} (max |kernel-plain| {err:.3e}); "
                f"kernel {ms:.4f} ms"
                + (f" (ladder {ladder_ms:.4f})" if lib_ms is not None
                   else "") + f", plain {plain_ms:.4f} ms"
                + (f", library {lib_ms:.4f} ms in turns"
                   if lib_ms is not None else "")
                + f", bound {bnd:.4f} ms ({by})")
            if not equal:
                raise AssertionError(f"S2 {name} differs from its plain "
                                     f"version: {err}")
            rows.append(dict(probe=name, body=body, shape=list(shape),
                             steps=n, err=err, ms=ms, ladder_ms=ladder_ms,
                             plain_ms=plain_ms, lib_ms=lib_ms, bound_ms=bnd,
                             bound_by=by))
    out["odd_cases"] = s2_odd(port, device)
    return out


def phase_scripts(port, device):
    """The port's scripts as a user runs them, each with the launch
    counts set to 0 just before it and read just after: S1 must launch
    in ``micro_admm``, S2 in each ladder and in ``probe_mosaic4``'s grid
    negate, the masked sweeps in ``probe_mosaic3``/``4``, whose
    ||I - XM||_max must stay within SWEEP_RESID_TOL."""
    import torch
    k = port.kernels
    pr = lambda t: log("  " + t)
    out = {}

    def counted(name, fn, needs):
        k.reset_launches()
        res = fn()
        torch.cuda.synchronize()
        counts = {key: v for key, v in k.launches.items() if v}
        log(f"  {name}: launches {counts}")
        if not all(counts.get(n, 0) > 0 for n in needs):
            raise AssertionError(f"{name}: a kernel of {needs} never "
                                 f"launched: {counts}")
        out[name] = dict(result=res, launches=counts)
        return res

    res = counted("micro_admm", lambda: port.micro_admm.run(
        BATCH, device, printer=pr), {S1})
    if not all(r["check"]["ok"] for r in res.values()):
        raise AssertionError("micro_admm: a configuration failed its check")
    out["micro_admm"]["result"] = {f"{v} unroll={u}": r
                                   for (v, u), r in res.items()}
    for name in ("probe_mosaic", "probe_mosaic2"):
        ladder = getattr(port, name).LADDER
        res = counted(name, lambda: port.probe_mosaic.run_ladder(
            ladder, device, printer=pr), {S2})
        if not all(r["equal"] for r in res):
            raise AssertionError(f"{name}: a probe differs")
    p3 = counted("probe_mosaic3", lambda: port.probe_mosaic3.run(
        BATCH, device, printer=pr), {K6S})
    p4 = counted("probe_mosaic4", lambda: port.probe_mosaic4.run(
        device, printer=pr), {S2, K6S})
    resids = [p3["resid"]] + [v["resid"] for key, v in p4.items()
                              if key != "grid negate"]
    if not p4["grid negate"]["equal"] or max(resids) > SWEEP_RESID_TOL:
        raise AssertionError(f"probe_mosaic3/4: {p3}, {p4}")
    return out


# --- 6: the stand-QP path -------------------------------------------------

def stand_setup(port, batch: int, device):
    """``gazebo_qp`` in fixed mode, ``make_flat_batch`` from seed 0 with
    the gate's staggered gait phases, and the stand and trot commands."""
    import torch
    cfg, params = port.config.load_profile(STAND_PROFILE, device=device)
    cfg = dataclasses.replace(cfg, mpc_solver_mode="fixed")
    pb, terr, carry = port.batched.make_flat_batch(
        cfg, torch.Generator().manual_seed(0), batch, params, device=device)
    carry = port.golden.staggered_gait(carry)
    joy_s = port.types.JoyCmd.zeros(device=device)
    joy_w = joy_s.replace(
        ctrl_state=torch.ones((), dtype=torch.int32, device=device),
        velx=torch.full((), 0.3, device=device))
    return cfg, pb, terr, carry, joy_s, joy_w


def stand_step(port, cfg, pb, terr, carry, joy, device, **kw):
    return port.batched.batched_stand_closed_loop_step(
        cfg, pb, terr, carry, joy, cfg.control_dt, device=device,
        **STAND_RESCUE, **kw)


def phase_stand(port, device):
    """The lock-step stand route at B = 4096: the stand and trot
    warm-up, then timed trot ticks with the launch counts and the host
    reads from 0 (solves/s, tick times, first-pass and final converged
    fractions, the ticks the rescue ran on, alive), a profile of 5 more;
    then ``control_tick`` over the first 1024 scenarios in both modes."""
    import torch
    k, tensors = port.kernels, port.tensors
    cfg, pb, terr, carry, joy_s, joy_w = stand_setup(port, STAND_BATCH,
                                                     device)
    t0 = time.perf_counter()
    for t in range(STAND_TICKS_QP + WALK_TICKS_QP):
        carry = stand_step(port, cfg, pb, terr, carry,
                           joy_s if t < STAND_TICKS_QP else joy_w, device)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    step = lambda c: stand_step(port, cfg, pb, terr, c, joy_w, device,
                                return_stats=True)
    k.reset_launches()
    tensors.host_syncs = 0
    events = [torch.cuda.Event(enable_timing=True)
              for _ in range(TIMED_TICKS_QP + 1)]
    first, final, rescued = [], [], []
    flips = torch.zeros((), dtype=torch.int64, device=device)
    t0 = time.perf_counter()
    events[0].record()
    for i in range(TIMED_TICKS_QP):
        prev = carry.cs.contacts
        carry, stats = step(carry)
        events[i + 1].record()
        first.append(stats["first_converged"])
        final.append(stats["converged"])
        if stats["rescued"]:
            rescued.append(i)
        flips += (carry.cs.contacts != prev).any(dim=1).sum()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(k.launches)
    reads = tensors.host_syncs / TIMED_TICKS_QP
    prof = profile_ticks(port, "stand_qp", step, carry)
    tick_ms = sorted(events[i].elapsed_time(events[i + 1])
                     for i in range(TIMED_TICKS_QP))
    z = carry.ps.root_pos[:, 2]
    alive = float((~torch.isnan(z)).float().mean())
    finite = bool(torch.isfinite(carry.cs.joint_torques).all())
    metrics = dict(
        batch=STAND_BATCH, warm_s=warm_s, ticks=TIMED_TICKS_QP,
        solves_per_s=STAND_BATCH * TIMED_TICKS_QP / wall,
        tick_ms_mean=sum(tick_ms) / len(tick_ms),
        tick_ms_p50=tick_ms[len(tick_ms) // 2],
        tick_ms_p99=tick_ms[int(0.99 * (len(tick_ms) - 1))],
        first_pass_converged=float(torch.stack(first).float().mean()),
        converged=float(torch.stack(final).float().mean()),
        rescue_ticks=rescued, host_reads_per_tick=reads, flips=int(flips),
        alive=alive, mean_z=float(torch.nanmean(z)), launches=counts,
        profile=prof)
    log(f"  stand_qp B={STAND_BATCH}: warm-up {STAND_TICKS_QP}+"
        f"{WALK_TICKS_QP} ticks in {warm_s:.1f} s; {TIMED_TICKS_QP} timed "
        f"ticks: {metrics['solves_per_s']:.1f} solves/s, tick mean "
        f"{metrics['tick_ms_mean']:.3f} ms p50 {metrics['tick_ms_p50']:.3f} "
        f"p99 {metrics['tick_ms_p99']:.3f}; converged first pass "
        f"{metrics['first_pass_converged']:.5f}, final "
        f"{metrics['converged']:.5f}; rescue ran on {len(rescued)} ticks "
        f"{rescued}; host reads/tick {reads}; contact flips {int(flips)}; "
        f"alive {alive}, mean z {metrics['mean_z']:.4f} m; kernel launches "
        f"{ {key: v for key, v in counts.items() if v} }")
    if alive != 1.0 or not finite or not flips:
        raise AssertionError(f"stand_qp: alive {alive}, torques finite "
                             f"{finite}, flips {int(flips)}")
    sub = lambda tree: port.tensors.tree_map(
        lambda a: a[:STAND_CONTROL_BATCH], tree)
    env = (cfg, sub(pb), sub(terr), joy_w)
    metrics["control_tick"] = control_ticks(
        port, env, sub(carry), device,
        modes={"fixed": {}, "adaptive": dict(mpc_solver_mode="adaptive")},
        label="stand ")
    return metrics


def phase_small_stand(port, device):
    """A B = 8 ``gazebo_qp`` batch stood up for 20 ticks on the CPU, then
    3 trot ticks (the first flips contacts) on the card and on the CPU
    from that one state: ``batched_stand_control_tick`` and
    ``control_tick`` in both modes. Torques, forces, contacts and the
    carried stand-QP state must agree within the stand QP's limits."""
    import torch
    cpu = torch.device("cpu")
    cfg, pb, terr, carry, joy_s, joy_w = stand_setup(port, SMALL_BATCH, cpu)
    for _ in range(20):
        carry = stand_step(port, cfg, pb, terr, carry, joy_s, cpu)
    to = lambda tree, dev: port.tensors.tree_map(lambda a: a.to(dev), tree)
    env = {dev: (to(pb, dev), to(terr, dev), to(joy_w, dev))
           for dev in (device, cpu)}
    diff = lambda a, b: float((a.cpu() - b).abs().max())
    limits = dict(torque=SMALL_QP_TQ_TOL, force=SMALL_QP_F_TOL,
                  warm_x=SMALL_QP_F_TOL, rho_factor=SMALL_RHO_FACTOR)
    routes = {"stand_lockstep": None, "stand_control_tick_fixed": {},
              "stand_control_tick_adaptive": dict(
                  mpc_solver_mode="adaptive")}
    worst = {}
    for route, kw in routes.items():
        def step(dev, c):
            p, tr, jw = env[dev]
            if kw is None:
                return stand_step(port, cfg, p, tr, c, jw, dev)
            return control_step(port, dataclasses.replace(cfg, **kw), p, tr,
                                c, jw)

        state = {dev: to(carry, dev) for dev in (device, cpu)}
        got = dict.fromkeys(limits, 0.0)
        flipped = False
        for tick in range(3):
            prev = state[cpu].cs.contacts
            state = {dev: step(dev, state[dev]) for dev in state}
            card, host = state[device], state[cpu]
            flipped |= bool((host.cs.contacts != prev).any())
            if not bool(torch.isfinite(card.cs.joint_torques).all()):
                raise AssertionError(f"small {route}: torques not finite")
            if not torch.equal(card.cs.contacts.cpu(), host.cs.contacts):
                raise AssertionError(f"small {route} tick {tick}: contacts "
                                     "differ")
            if not torch.equal(card.mem.qp_prev_contacts.cpu(),
                               host.mem.qp_prev_contacts):
                raise AssertionError(f"small {route} tick {tick}: "
                                     "qp_prev_contacts differ")
            ratio = card.mem.qp_rho.cpu() / host.mem.qp_rho
            now = dict(
                torque=diff(card.cs.joint_torques, host.cs.joint_torques),
                force=diff(card.cs.foot_forces_grf, host.cs.foot_forces_grf),
                warm_x=diff(card.mem.qp_warm_x, host.mem.qp_warm_x),
                rho_factor=float(torch.maximum(ratio, 1.0 / ratio).max()))
            got = {key: max(v, now[key]) for key, v in got.items()}
        log(f"  small B={SMALL_BATCH} {route}: card vs CPU max |d| "
            + ", ".join(f"{key} {v:.3e} (tol {limits[key]})"
                        for key, v in got.items())
            + f"; contacts and qp_prev_contacts equal; a flip {flipped}")
        if any(v > limits[key] for key, v in got.items()) or not flipped:
            raise AssertionError(f"small {route}: {got}, flip {flipped}")
        worst[route] = got
    return worst


def phase_gate(port, device):
    """The port's stand gate on the card, at the JAX test's limits,
    beside the JAX package's dense gate record."""
    t0 = time.perf_counter()
    rep = port.golden.run_stand_batched_gate(1.0, 2, 3, device=device)
    rep["seconds"] = time.perf_counter() - t0
    golden = ROOT / "GOLDEN_REPORT.json"
    ref = (json.loads(golden.read_text()).get("stand_lockstep_batched", {})
           if golden.exists() else {})
    log(f"  stand gate (1.0 s, every 2nd tick, B = 3): {rep['samples']} "
        f"samples, max {rep['max_dev_N']:.4f} N, p95 "
        f"{rep['p95_dev_N']:.4f} N, mean {rep['mean_dev_N']:.4f} N, frac "
        f"within {rep['tol_N']} N {rep['frac_within_tol']}, nan "
        f"{rep['nan']}, {rep['seconds']:.1f} s; GOLDEN_REPORT.json "
        f"stand_lockstep_batched (the JAX package, 5 s dense): max "
        f"{ref.get('max_dev_N', float('nan')):.4f} N, p95 "
        f"{ref.get('p95_dev_N', float('nan')):.4f} N, mean "
        f"{ref.get('mean_dev_N', float('nan')):.4f} N")
    if (rep["nan"] or rep["samples"] < GATE_MIN_SAMPLES
            or rep["frac_within_tol"] != 1.0
            or rep["max_dev_N"] >= GATE_MAX_DEV):
        raise AssertionError(f"stand gate: {rep}")
    rep["golden_report"] = ref
    return rep


def phase_golden(port, device):
    """The MPC golden gates on the card: the batched amortized gate at
    its record's protocol (K1's and K2's launches counted in it) and a
    short ``fixed_25it_rescue`` gate, beside their records."""
    golden, k = port.golden, port.kernels
    records = json.loads((ROOT / "GOLDEN_REPORT.json").read_text())
    workers = max(1, (os.cpu_count() or 1) - 1)
    log(f"  host: {os.cpu_count()} CPUs, {workers} float64 solver workers")
    k.reset_launches()
    t0 = time.perf_counter()
    amort = golden.run_amortized_gate(workers=workers, device=device)
    amort["wall_s"] = time.perf_counter() - t0
    amort["launches"] = {name: k.launches[name] for name in (K1, K2)}
    t0 = time.perf_counter()
    fixed = golden.run_gate(
        **FIXED_GATE, verbose=False, workers=workers, device=device,
        **port.run_golden_dense.SHIPPED)
    fixed["wall_s"] = time.perf_counter() - t0
    out = {}
    for name, rep, key, note in (
            ("amortized", amort, "amortized_batched",
             "16 scenarios, 2.5 s, every 3rd tick from 1 s"),
            ("fixed_25it_rescue", fixed, "fixed_25it_rescue",
             "2 s, every 10th tick from 1 s")):
        ref = records.get(key, {})
        extra = (f", alive {rep['alive_frac']}, launches {rep['launches']}"
                 if name == "amortized" else "")
        log(f"  {name} gate ({note}): {rep['samples']} samples, max "
            f"{rep['max_dev_N']:.4f} N, p95 {rep['p95_dev_N']:.4f} N, mean "
            f"{rep['mean_dev_N']:.4f} N, frac within {rep['tol_N']} N "
            f"{rep['frac_within_tol']}, nan {rep['nan']}{extra}, "
            f"{rep['wall_s']:.1f} s; GOLDEN_REPORT.json {key} (the JAX "
            f"package's record, {ref.get('samples')} samples): frac "
            f"{ref.get('frac_within_tol')}, max "
            f"{ref.get('max_dev_N', float('nan')):.4f} N, p95 "
            f"{ref.get('p95_dev_N', float('nan')):.4f} N")
        rep["golden_report"] = {f: ref.get(f) for f in (
            "samples", "max_dev_N", "p95_dev_N", "mean_dev_N",
            "frac_within_tol")}
        out[name] = rep
    if amort["worst"]:
        log(f"  amortized gate's worst samples: {amort['worst']}")
    if (amort["nan"] or amort["alive_frac"] != 1.0
            or amort["samples"] != AMORTIZED_GATE_SAMPLES
            or amort["frac_within_tol"] < AMORTIZED_GATE_MIN_FRAC
            or not all(amort["launches"].values())):
        raise AssertionError(f"amortized gate: {amort}")
    if fixed["nan"] or fixed["frac_within_tol"] != 1.0:
        raise AssertionError(f"fixed_25it_rescue gate: {fixed}")
    return out


def phase_terrain(port, device):
    """``bench.py``'s terrain evaluation on the port: ``make_batch`` of
    ``TERRAIN_BATCH`` scenarios from a seeded generator, a warm
    ``batched_rollout`` of ``TERRAIN_STEPS`` steps, then a timed one from
    where it ended; the kernels' launches counted from 0 just before the
    two and read just after. Every scenario must stay alive, no height
    error may be NaN. The JAX package's record (``BENCH_r05.json``, other
    draws) is printed beside, not held."""
    import numpy as np
    import torch
    k, batched = port.kernels, port.batched
    cfg, params = port.config.load_profile("gazebo_mpc", device=device)
    cfg = dataclasses.replace(cfg, **TERRAIN_SCHEDULE)
    gen = torch.Generator().manual_seed(1)
    pb, terrain, carry = batched.make_batch(cfg, gen, TERRAIN_BATCH, params,
                                            device=device)
    joy = port.closed_loop.joy_schedule(
        TERRAIN_STEPS, walk_after=TERRAIN_STEPS // 4, velx=0.3,
        device=device)
    k.reset_launches()
    t0 = time.perf_counter()
    carry, _, _ = batched.batched_rollout(cfg, pb, terrain, carry, joy,
                                          TERRAIN_STEPS, device=device)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    carry, errs, metrics = batched.batched_rollout(
        cfg, pb, terrain, carry, joy, TERRAIN_STEPS, device=device)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: n for name, n in k.launches.items() if n}
    tail = errs[-TERRAIN_STEPS // 4:].cpu().numpy()
    per_scen = tail.mean(axis=0)
    pitch, steph = terrain.pitch.cpu().numpy(), terrain.step_height.cpu(
        ).numpy()
    kinds = {"flat": (pitch == 0) & (steph == 0), "slope": pitch != 0,
             "stairs": steph != 0}
    rep = dict(
        scenarios=TERRAIN_BATCH, steps=TERRAIN_STEPS,
        mean_height_err_m=float(metrics["mean_height_err"]),
        p95_height_err_m=float(metrics["p95_height_err"]),
        alive_frac=float(metrics["alive_frac"]),
        by_kind={name: dict(n=int(m.sum()),
                            mean_height_err_m=float(per_scen[m].mean()),
                            p95_height_err_m=float(np.percentile(
                                tail[:, m], 95)))
                 for name, m in kinds.items() if m.any()},
        scenario_ticks_per_s=TERRAIN_BATCH * TERRAIN_STEPS / wall,
        warm_s=warm_s, wall_s=wall, launches=launches,
        nan=bool(torch.isnan(errs).any() or torch.isnan(
            carry.ps.root_pos).any()))
    bench = ROOT / "BENCH_r05.json"
    ref = (json.loads(bench.read_text())["parsed"]["extra"]
           .get("terrain_eval", {}) if bench.exists() else {})
    log(f"  terrain eval (B = {TERRAIN_BATCH}, {TERRAIN_STEPS} steps, walk "
        f"from {TERRAIN_STEPS // 4}): alive {rep['alive_frac']}, mean "
        f"height error {rep['mean_height_err_m']:.4f} m, p95 "
        f"{rep['p95_height_err_m']:.4f} m, nan {rep['nan']}; by kind "
        + ", ".join(f"{name} n={v['n']} mean {v['mean_height_err_m']:.4f} "
                    f"p95 {v['p95_height_err_m']:.4f}"
                    for name, v in rep["by_kind"].items())
        + f"; warm rollout {warm_s:.1f} s, timed {wall:.1f} s "
        f"({rep['scenario_ticks_per_s']:.1f} scenario-ticks/s); kernel "
        f"launches {launches or 'none'}; BENCH_r05.json terrain_eval (the "
        f"JAX package's record, other draws, not a target): mean "
        f"{ref.get('mean_height_err_m')} m, p95 "
        f"{ref.get('p95_height_err_m')} m, alive {ref.get('alive_frac')}")
    if rep["alive_frac"] != 1.0 or rep["nan"]:
        raise AssertionError(f"terrain eval: {rep}")
    rep["bench_r05"] = ref
    return rep


def phase_dual_rate(port, device):
    """``run_dual_rate_sim`` on the card for ``DUAL_RATE['seconds']`` with
    the JAX test's joystick, the kernels' launches counted from 0 just
    before it and read just after; held to the JAX test's asserts."""
    import torch
    k = port.kernels
    cfg, params = port.config.load_profile("gazebo_mpc", device=device)
    cfg = dataclasses.replace(cfg, **DUAL_RATE_SCHEDULE)
    joy = port.types.JoyCmd.zeros(device=device)
    joy = joy.replace(ctrl_state=torch.ones_like(joy.ctrl_state),
                      velx=torch.full_like(joy.velx, 0.3))
    k.reset_launches()
    t0 = time.perf_counter()
    rep = port.realtime.run_dual_rate_sim(
        cfg, port.tensors.broadcast_batch(params, 1),
        port.terrain.Terrain.flat(1, device=device), joy=joy,
        device=device, **DUAL_RATE)
    rep["wall_s"] = time.perf_counter() - t0
    rep["launches"] = {name: n for name, n in k.launches.items() if n}
    log(f"  dual-rate sim ({DUAL_RATE['seconds']} s, walk from "
        f"{DUAL_RATE['walk_after_s']} s): {rep['est_steps']} estimate and "
        f"{rep['ctrl_steps']} control steps, final x "
        f"{rep['final_x_m'][0]:.4f} m, z {rep['final_z_m'][0]:.4f} m, nan "
        f"{rep['nan']}, {rep['wall_s']:.1f} s; kernel launches "
        f"{rep['launches'] or 'none'}")
    z, x = rep["final_z_m"][0], rep["final_x_m"][0]
    if (rep["nan"] or any(rep[key] != v for key, v in DUAL_RATE_STEPS.items())
            or not DUAL_RATE_Z[0] < z < DUAL_RATE_Z[1]
            or not x > DUAL_RATE_MIN_X):
        raise AssertionError(f"dual-rate sim: {rep}")
    return rep


def executor_checks(port) -> dict:
    """``tests/test_runtime.py``'s ring and loop checks on the port's own
    build of ``native/rt_executor.cc``, and a raising callback: its first
    exception from ``stop()``, the callback not called again."""
    import numpy as np
    nat = port.native
    t0 = time.perf_counter()
    lib = nat.build()
    build_s = time.perf_counter() - t0
    ring = nat.SensorRing(4)
    assert ring.pop_latest() is None
    for i in range(10):
        ring.push(np.full(4, float(i), np.float32))
    assert (ring.pop_latest() == 9.0).all() and ring.pop_latest() is None
    ring = nat.SensorRing(2, capacity_pow2=2)
    for i in range(10):
        ring.push(np.full(2, float(i), np.float32))
    assert ring.dropped > 0 and (ring.pop_latest() == 9.0).all()
    for _ in range(3):     # the best of 3, as the test
        count = [0]
        loop = nat.RtLoop(0.005, lambda _t: count.__setitem__(
            0, count[0] + 1), compensate=True)
        loop.start()
        time.sleep(0.25)
        loop.stop()
        rate = loop.stats()
        assert rate["iterations"] == count[0], rate
        if (30 <= rate["iterations"] <= 60
                and rate["missed_deadlines"] == 0
                and rate["mean_jitter_ms"] < 1.0):
            break
    else:
        raise AssertionError(f"RtLoop at 5 ms: {rate}")
    loop = nat.RtLoop(0.005, lambda _t: time.sleep(0.01), compensate=True)
    loop.start()
    time.sleep(0.2)
    loop.stop()
    over = loop.stats()
    assert over["missed_deadlines"] == over["iterations"] > 0, over
    calls = []

    def fails(tick):
        calls.append(tick)
        if tick >= 2:
            raise ValueError(f"tick {tick}")

    loop = nat.RtLoop(0.002, fails, compensate=False)
    loop.start()
    deadline = time.monotonic() + 10.0
    while loop.error is None and time.monotonic() < deadline:
        time.sleep(0.005)
    try:
        loop.stop()
        raise AssertionError("a raising callback did not fail stop()")
    except ValueError as e:
        assert str(e) == "tick 2" and calls == [0, 1, 2], (e, calls)
    return dict(library=str(lib.relative_to(ROOT)), build_s=build_s,
                loop_5ms=rate, overrun=over)


def tick_alone(port, runner, rate, reps: int = 10) -> dict:
    """The runner's control tick (``control_tick``, or
    ``control_tick_noest`` in the sensor-rate schedule) on its state after
    the run, without the loops' threads: p50 and mean ms over ``reps``
    calls, each ended by a synchronize (host clock)."""
    import torch
    r, ctl = runner, port.controller
    sensors = port.plant.read_sensors(r.params, r.ps, r.prev_vel, r.dt)
    fn = ((lambda: ctl.control_tick_noest(r.cfg, r.params, r.cs, r.mem,
                                          r.joy, r.dt)) if rate else
          (lambda: ctl.control_tick(r.cfg, r.params, r.cs, r.mem, sensors,
                                    r.joy, r.dt)))
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return dict(p50=statistics.median(times), mean=statistics.mean(times))


def runner_run(port, device, schedule: str) -> dict:
    """``RealtimeRunner`` for ``RUNNER_SECONDS`` in one schedule, its
    telemetry to a temporary JSONL whose records must number its ticks
    over ``RUNNER_EVERY``; the plant finite, its height in ``RUNNER_Z``."""
    import math
    import tempfile
    k = port.kernels
    rate = 500.0 if schedule == "sensor_rate_ekf" else None
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "live.jsonl"
        with port.realtime.RealtimeRunner(
                estimation_rate_hz=rate, telemetry_jsonl=str(path),
                telemetry_every=RUNNER_EVERY, device=device,
                **RUNNER) as runner:
            k.reset_launches()
            stats = runner.run(RUNNER_SECONDS)
            launches = {name: n for name, n in k.launches.items() if n}
            stats["tick_alone_ms"] = tick_alone(port, runner, rate)
        records = [json.loads(line)
                   for line in path.read_text().splitlines()]
    stats.update(schedule=schedule, records=len(records), launches=launches)
    z = stats["root_pos"][2]
    log(f"  runner {schedule} ({RUNNER_SECONDS} s, {RUNNER}): "
        + ", ".join(f"{key} {stats.get(key)}" for key in (
            "iterations", "missed_deadlines", "ticks", "solve_p50_ms",
            "solve_p99_ms", "mean_work_ms", "max_work_ms", "ring_dropped",
            "root_pos", "records", "tick_alone_ms"))
        + f"; warm-up {stats['warm_s']:.2f} s; kernel launches "
        f"{launches or 'none'}")
    if (stats["iterations"] <= 0 or stats["ticks"] <= 0
            or not all(math.isfinite(v) for v in stats["root_pos"])
            or not RUNNER_Z[0] < z < RUNNER_Z[1]
            or len(records) != stats["ticks"] // RUNNER_EVERY
            or any(r["tick"] != (i + 1) * RUNNER_EVERY
                   for i, r in enumerate(records))):
        raise AssertionError(f"RealtimeRunner {schedule}: {stats}")
    return stats


def wire_run(port, device, fmt: str, seconds: float, n_hs: int,
             frames: int, ticks: int) -> dict:
    """``tests/test_wire.py``'s loop in ``fmt``: the handshake served from
    a thread (the robot sees only the zero-torque burst), then ``seconds``
    of the lock-step exchange, held to the test's assertions."""
    import threading
    import torch
    wire, k = port.wire, port.kernels
    cfg, params = port.config.load_profile("gazebo_mpc", device=device)
    cfg = dataclasses.replace(cfg, mpc_qp_iters=50, mpc_solver_mode="fixed")
    params = port.tensors.broadcast_batch(params, 1)
    mock = wire.MockA1Robot(params, port.terrain.Terrain.flat(
        1, device=device), wire_format=fmt, device=device)
    runner = wire.HardwareWireRunner(cfg, params, mock.addr,
                                     wire_format=fmt, device=device)
    try:
        t = threading.Thread(target=lambda: [mock.serve_once()
                                             for _ in range(n_hs)])
        t.start()
        got = runner.handshake(n_hs)
        t.join(timeout=60)
        hs = dict(replies=got, zero_torque=mock.zero_torque_cmds,
                  nonzero_seen=mock.nonzero_seen)
        k.reset_launches()
        t0 = time.perf_counter()
        rep = runner.run(seconds, port.types.JoyCmd.zeros(device=device),
                         mock)
        torch.cuda.synchronize()
        rep["wall_s"] = time.perf_counter() - t0
        rep["launches"] = {name: n for name, n in k.launches.items() if n}
    finally:
        runner.close()
        mock.close()
    rep.update(format=fmt, seconds=seconds, handshake=hs)
    log(f"  wire {fmt} ({seconds} s after a handshake of {n_hs}): "
        f"{rep['frames']} frames, {rep['ctrl_steps']} control ticks, "
        f"handshake {hs}, final root {rep['final_root']}, nan {rep['nan']}, "
        f"ring dropped {rep['ring_dropped']}, {rep['wall_s']:.2f} s wall "
        f"({rep['wall_s'] / rep['frames'] * 1e3:.2f} ms a frame); kernel "
        f"launches {rep['launches'] or 'none'}")
    if (hs != dict(replies=n_hs, zero_torque=n_hs, nonzero_seen=False)
            or rep["frames"] != frames or rep["ctrl_steps"] != ticks
            or rep["nan"]
            or not WIRE_Z[0] < rep["final_root"][2] < WIRE_Z[1]):
        raise AssertionError(f"wire {fmt}: {rep}")
    return rep


def cli_run(name: str, args: list) -> dict:
    """One CLI command in a subprocess, on the card: exit code, wall
    time, its JSON (stdout), the tail of its errors."""
    t0 = time.perf_counter()
    launcher = TORCHRUN if name == "batch_2_ranks" else []
    out = subprocess.run([sys.executable, *launcher, "-m", CLI, *args],
                         cwd=ROOT,
                         capture_output=True, text=True,
                         timeout=CLI_TIMEOUT_S)
    wall = time.perf_counter() - t0
    try:
        result = json.loads(out.stdout) if out.stdout.strip() else None
    except json.JSONDecodeError:
        result = out.stdout[-2000:]
    rec = dict(args=args, rc=out.returncode, wall_s=wall, json=result,
               stderr_tail=out.stderr[-2000:])
    log(f"  cli {name}: python {' '.join(launcher)} -m {CLI} "
        f"{' '.join(args)}: rc "
        f"{out.returncode}, {wall:.1f} s wall; "
        + json.dumps(result if out.returncode == 0 or result
                     else out.stderr[-300:]))
    return rec


def cli_runs(commands: dict, beside):
    """Every command at once, a subprocess each, a thread waiting on each,
    while ``beside()`` runs in this process; each command's wall time is
    its own process's, under the others' load. Returns (the commands'
    records, what ``beside`` returned)."""
    import threading
    done = {}

    def one(name, args):
        try:
            done[name] = cli_run(name, args)
        except Exception as e:   # a timeout: cli_checks fails it
            done[name] = dict(args=args, rc=None, wall_s=None, json=None,
                              stderr_tail=repr(e))

    threads = [threading.Thread(target=one, args=item)
               for item in commands.items()]
    for t in threads:
        t.start()
    try:
        other = beside()
    finally:
        for t in threads:
            t.join()
    return {name: done[name] for name in commands}, other


def batch_in_turn(port, device) -> dict:
    """``batch`` at its defaults as ``BATCH_RANKS`` ranks would run it,
    but in this process, one rank's block after the other, each block
    with its own ``batched_rollout``; the metrics taken here over the
    whole batch (the errors of every block together). Beside them, what
    two wrong reductions of a sharded run would give: rank 0's block
    alone, and the blocks' p95 averaged."""
    import torch
    d, mesh, batched = BATCH_DEFAULTS, port.mesh, port.batched
    cfg, params = port.config.load_profile(d["profile"], device=device)
    cfg = dataclasses.replace(cfg, mpc_qp_iters=d["mpc_iters"],
                              mpc_solver_mode="fixed")
    trees = batched.make_batch(cfg, torch.Generator().manual_seed(d["seed"]),
                               d["n"], params, device=device)
    joy = port.closed_loop.joy_schedule(
        d["steps"], walk_after=d["steps"] // 4, velx=d["velx"],
        device=device)
    t0 = time.perf_counter()
    tails, alive = [], []
    for idx in range(BATCH_RANKS):
        pb, tb, carry = (mesh.take_block(t, idx, BATCH_RANKS)
                         for t in trees)
        carry, errs, _ = batched.batched_rollout(cfg, pb, tb, carry, joy,
                                                 d["steps"], device=device)
        tails.append(errs[-d["steps"] // 4:].T)
        alive.append(~torch.isnan(carry.ps.root_pos[:, 2]))
    p95 = lambda x: float(torch.quantile(x.flatten(), 0.95))
    whole = torch.cat(tails)
    rep = dict(
        wall_s=time.perf_counter() - t0,
        metrics=dict(mean_height_err=float(whole.double().mean()),
                     p95_height_err=p95(whole),
                     alive_frac=float(torch.cat(alive).double().mean())),
        rank0_p95=p95(tails[0]),
        mean_of_block_p95=sum(p95(t) for t in tails) / len(tails))
    log(f"  batch blocks in turn ({BATCH_RANKS} of {d['n'] // BATCH_RANKS}, "
        f"{d['steps']} steps, this process): {rep['wall_s']:.1f} s, "
        f"{rep['metrics']}; rank 0's p95 alone {rep['rank0_p95']}, the "
        f"blocks' p95 averaged {rep['mean_of_block_p95']}")
    return rep


def cli_checks(cli: dict, in_turn: dict) -> None:
    """Each command exits as the JAX package's would on this protocol:
    0 with a finite result (the golden gate's every sample within its
    tolerance, the wire's frame counts), the refusals non-zero with the
    startup precondition's message; ``batch`` over two ranks prints the
    metrics of the whole batch, those of its blocks run in turn
    (:func:`batch_in_turn`) within ``BATCH_REL_TOL``."""
    import math
    bad = [name for name, rec in cli.items()
           if name in {**CLI_COMMANDS, **CLI_EXTRA}
           and (rec["rc"] != 0 or not isinstance(rec["json"], dict))]
    if not bad:
        sim, rt, batch, gate, wire = (cli[n]["json"] for n in CLI_COMMANDS)
        joint, ranks = (cli[n]["json"] for n in CLI_EXTRA)
        checks = {
            "sim": not sim["nan"] and sim["ticks"] == 200,
            "realtime": rt["iterations"] > 0 and all(
                math.isfinite(v) for v in rt["root_pos"])
            and RUNNER_Z[0] < rt["root_pos"][2] < RUNNER_Z[1],
            "batch": batch["alive_frac"] == 1.0,
            "golden": not gate["nan"] and gate["samples"] == 8
            and gate["frac_within_tol"] == 1.0,
            "wire": wire["frames"] == 250 and wire["ctrl_steps"] == 200
            and wire["handshake_replies"] == 10 and not wire["nan"]
            and WIRE_Z[0] < wire["final_root"][2] < WIRE_Z[1],
            "sim_joint": not joint["nan"] and joint["ticks"] == 200
            and WIRE_Z[0] < joint["final_pos"][2] < WIRE_Z[1],
            "batch_2_ranks": ranks["alive_frac"] == 1.0
            and ranks.keys() == batch.keys() == in_turn["metrics"].keys()
            and all(math.isclose(ranks[k], v, rel_tol=BATCH_REL_TOL)
                    for k, v in in_turn["metrics"].items()),
        }
        log("  batch over two ranks against its blocks in turn, relative: "
            + json.dumps({k: abs(ranks[k] - v) / abs(v) if v else
                          abs(ranks[k]) for k, v in
                          in_turn["metrics"].items()})
            + "; against the one-rank run of 64: "
            + json.dumps({k: abs(ranks[k] - v) / abs(v) if v else
                          abs(ranks[k]) for k, v in batch.items()}))
        bad = [name for name, ok in checks.items() if not ok]
    bad += [name for name in CLI_REFUSALS
            if cli[name]["rc"] == 0
            or "startup precondition" not in cli[name]["stderr_tail"]]
    if bad:
        raise AssertionError(f"CLI commands {bad}: "
                             + json.dumps({n: cli[n] for n in bad}))


def phase_runtime(port, device):
    """The runtime and the CLI on the card: the native executor built
    from the port's source and checked; ``RealtimeRunner`` in both
    schedules, alone; then each of the five CLI commands as a user runs
    it and the two refusals, all at once (a subprocess each), while the
    wire loop runs here in both formats and then ``batch``'s blocks in
    turn (:func:`batch_in_turn`). No hand kernel runs here (the
    tick is ``control_tick``'s): the launches are read around the
    in-process runs and printed."""
    executor = executor_checks(port)
    log(f"  executor: {executor}")
    runners = {schedule: runner_run(port, device, schedule)
               for schedule in ("sim", "sensor_rate_ekf")}
    t0 = time.perf_counter()
    cli, (wires, in_turn) = cli_runs(
        {**CLI_COMMANDS, **CLI_EXTRA, **CLI_REFUSALS},
        beside=lambda: ({fmt: wire_run(port, device, fmt, *rest)
                         for fmt, *rest in WIRE_RUNS},
                        batch_in_turn(port, device)))
    log(f"  cli: {len(cli)} commands at once, beside the wire loops and "
        f"the batch's blocks in turn, in {time.perf_counter() - t0:.1f} s")
    cli_checks(cli, in_turn)
    return dict(executor=executor, runner=runners, wire=wires,
                batch_in_turn=in_turn,
                cli={name: {k: v for k, v in rec.items()
                            if k != "stderr_tail"}
                     for name, rec in cli.items()})


def joint_states(port, b: int):
    """``b`` seeded states of the articulated plant in four equal groups,
    float64 on the CPU, and their torques: standing under the stance
    map's torques with perturbed joints and velocities, the pins at the
    perturbed feet; legs 0 and 3 in swing, their knees flexed 0.4 rad;
    in flight, 0.1 m up; legs 1 and 2 just touching down (knees extended
    0.06 rad into the ground, falling at 0.1 m/s). Returns (params,
    terrain, state, torques)."""
    import torch
    jp, kin, mathx = port.joint_plant, port.kinematics, port.mathx
    cpu, f64 = torch.device("cpu"), torch.float64
    _, params = port.config.load_profile("gazebo_mpc", device=cpu)
    pb = port.tensors.tree_map(
        lambda a: a.double() if a.is_floating_point() else a,
        port.tensors.broadcast_batch(params, b))
    terr = port.terrain.Terrain.flat(b, dtype=f64, device=cpu)
    ps = jp.init_standing(pb, terr, 0.3, dtype=f64, device=cpu)
    gen = torch.Generator().manual_seed(16)
    noise = lambda std, *shape: std * torch.randn(
        (b,) + shape, generator=gen, dtype=f64)
    g = b // 4
    q = ps.joint_pos + noise(0.03, 12)
    contact = ps.in_contact.clone()
    for leg in (0, 3):
        q[g:2 * g, 3 * leg + 2] -= 0.4
        contact[g:2 * g, leg] = False
    contact[2 * g:3 * g] = False
    for leg in (1, 2):
        q[3 * g:, 3 * leg + 2] += 0.06
        contact[3 * g:, leg] = False
    root = ps.root_pos.clone()
    root[2 * g:3 * g, 2] += 0.1
    lin = noise(0.05, 3)
    lin[3 * g:, 2] = -0.1
    quat = mathx.euler_to_quat(noise(0.03, 3))
    legs = q.reshape(b, 4, 3)
    feet = root[:, None, :] + torch.einsum(
        "bij,blj->bli", mathx.quat_to_rot(quat),
        kin.fk(legs, torch.zeros(3, dtype=f64), pb.rho_fix))
    ps = ps.replace(
        root_pos=root, root_quat=quat, root_lin_vel=lin,
        root_ang_vel=noise(0.1, 3), joint_pos=q, joint_vel=noise(0.2, 12),
        in_contact=contact,
        pin_anchor=torch.where(contact[..., None], feet, ps.pin_anchor))
    weight = pb.robot_mass * 9.81 / 4.0
    grf = torch.zeros(b, 4, 3, dtype=f64)
    grf[..., 2] = -weight[:, None]
    tau = torch.einsum("blji,blj->bli", kin.jac(legs, pb.rho_opt,
                                                pb.rho_fix), grf)
    return pb, terr, ps, tau.reshape(b, 12) + noise(0.3, 12)


def joint_diff(card, host, dtype: str) -> dict:
    """Each field's largest distance, card against CPU, and the fields
    outside the tolerance (``JOINT_*``); flags must be equal."""
    import torch
    dist, bad = {}, []
    for name in dataclasses.fields(card):
        k = name.name
        a, h = getattr(card, k).cpu(), getattr(host, k)
        if a.dtype == torch.bool:
            dist[k] = int((a != h).sum())
            bad += [k] if dist[k] else []
            continue
        dist[k] = float((a.double() - h.double()).abs().max())
        if dtype == "float64":
            ok = dist[k] <= JOINT_F64_TOL
        elif k == "foot_force_n":
            ok = dist[k] <= JOINT_FORCE_TOL
        else:
            ok = dist[k] <= (JOINT_F32_ATOL + JOINT_F32_RTOL
                             * float(h.double().abs().max()))
        bad += [] if ok else [k]
    return dict(max_abs=dist, outside=bad)


def joint_card_vs_cpu(port, device) -> dict:
    """One ``_substep`` and one ``plant_step`` (``JOINT_SUBSTEPS``) at
    ``JOINT_BATCH`` from :func:`joint_states`, on the card and on the
    CPU, in float64 and float32."""
    import torch
    jp, tensors = port.joint_plant, port.tensors
    pb, terr, ps, tau = joint_states(port, JOINT_BATCH)
    out = {}
    for dtype, tdt in (("float64", torch.float64),
                       ("float32", torch.float32)):
        cast = lambda tree, dev: tensors.tree_map(
            lambda a: a.to(dev, tdt) if a.is_floating_point()
            else a.to(dev), tree)
        dt = torch.tensor(JOINT_DT, dtype=tdt)
        runs = {}
        for where, dev in (("card", device), ("cpu", torch.device("cpu"))):
            args = (cast(pb, dev), cast(terr, dev), cast(ps, dev),
                    tau.to(dev, tdt))
            sub, info = jp._substep(*args, dt.to(dev) / JOINT_SUBSTEPS)
            if bool((info != 0).any()):
                raise AssertionError(f"joint plant {where} {dtype}: "
                                     f"singular KKT")
            runs[where] = (sub, jp.plant_step(*args, dt.to(dev),
                                              JOINT_SUBSTEPS))
        for i, what in enumerate(("substep", "plant_step")):
            rep = joint_diff(runs["card"][i], runs["cpu"][i], dtype)
            out[f"{what}_{dtype}"] = rep
            log(f"  joint plant card vs CPU, {what} {dtype} (B = "
                f"{JOINT_BATCH}): " + ", ".join(
                    f"{k} {v:.3g}" for k, v in rep["max_abs"].items()))
        ref = runs["cpu"][1]
        out[f"transitions_{dtype}"] = dict(
            touched_down=int((~ps.in_contact & ref.in_contact.cpu()).sum()),
            released=int((ps.in_contact & ~ref.in_contact.cpu()).sum()))
    log(f"  joint plant contact transitions over the plant_step (CPU): "
        + json.dumps({k: v for k, v in out.items()
                      if k.startswith("transitions")}))
    bad = {k: v["outside"] for k, v in out.items() if v.get("outside")}
    if bad:
        raise AssertionError(f"joint plant card vs CPU: {bad}")
    return out


def joint_physics(port, device) -> dict:
    """``tests/test_joint_plant.py:38-117`` on the card: free fall, torque
    saturation, standing equilibrium, the sensors at rest."""
    import torch
    jp, kin = port.joint_plant, port.kinematics
    _, params = port.config.load_profile("gazebo_mpc", device=device)
    pb = port.tensors.broadcast_batch(params, 1)
    terr = port.terrain.Terrain.flat(1, device=device)
    ps0 = jp.init_standing(pb, terr, 0.3, device=device)
    dt = torch.tensor(JOINT_DT, device=device)
    rep = {}

    up = torch.tensor([0.0, 0.0, 5.0], device=device)
    ps = ps0.replace(root_pos=ps0.root_pos + up,
                     foot_pos=ps0.foot_pos + up,
                     in_contact=torch.zeros_like(ps0.in_contact))
    z0 = float(ps.root_pos[0, 2])
    for _ in range(40):
        ps = jp.plant_step(pb, terr, ps, torch.zeros(1, 12, device=device),
                           dt, substeps=2)
    t = 40 * JOINT_DT
    rep["free_fall_err_m"] = abs(float(ps.root_pos[0, 2])
                                 - (z0 - 0.5 * 9.81 * t * t))

    big = jp.plant_step(pb, terr, ps0, torch.full((1, 12), 1e6,
                                                  device=device), dt, 5)
    lim = jp.plant_step(pb, terr, ps0, torch.full(
        (1, 12), jp.TORQUE_LIMIT, device=device), dt, 5)
    rep["saturation_dqd"] = float((big.joint_vel - lim.joint_vel).abs().max())
    sat_ok = torch.allclose(big.joint_vel, lim.joint_vel, rtol=1e-5,
                            atol=1e-6)

    weight = float(params.robot_mass) * 9.81
    jacs = kin.jac(ps0.joint_pos.reshape(1, 4, 3), pb.rho_opt, pb.rho_fix)
    f = torch.tensor([0.0, 0.0, -weight / 4.0], device=device)
    tau = torch.einsum("zlba,b->zla", jacs, f).reshape(1, 12)
    ps = ps0
    for _ in range(20):
        ps = jp.plant_step(pb, terr, ps, tau, dt, substeps=5)
    rep["stand_force_frac"] = float(ps.foot_force_n.sum()) / weight
    rep["stand_feet_moved_m"] = float((ps.foot_pos - ps0.foot_pos).abs().max())
    rep["stand_z_m"] = float(ps.root_pos[0, 2])

    s = jp.read_sensors(pb, ps0, ps0.root_lin_vel, dt)
    rep["imu_acc"] = s.imu_acc[0].tolist()
    ok = (rep["free_fall_err_m"] < 0.01 and sat_ok
          and abs(rep["stand_force_frac"] - 1.0) < 0.12
          and rep["stand_feet_moved_m"] < 2e-3
          and abs(rep["stand_z_m"] - 0.3) < 0.01
          and max(abs(a - b) for a, b in zip(rep["imu_acc"],
                                             (0.0, 0.0, 9.81))) < 1e-3)
    log(f"  joint plant physics on the card: {rep}")
    if not ok:
        raise AssertionError(f"joint plant physics: {rep}")
    return rep


def joint_state_file(name: str) -> Path:
    """Where a ``JOINT_ROLLOUTS`` protocol's process leaves its last
    state and torques for :func:`joint_step_alone`."""
    return ROOT / "build" / f"joint_{name}.pt"


def joint_env(port, device, name: str):
    """(cfg, one scenario's params, flat terrain) of a protocol."""
    tensors = port.tensors
    spec = JOINT_ROLLOUTS[name]
    cfg, params = port.config.load_profile(spec["profile"], device=device)
    cfg = dataclasses.replace(cfg, mpc_qp_iters=JOINT_MPC_ITERS)
    return (cfg, tensors.broadcast_batch(params, 1),
            port.terrain.Terrain.flat(1, device=device))


def joint_rollout(port, device, name: str) -> dict:
    """One ``JOINT_ROLLOUTS`` protocol through ``rollout(plant=
    joint_plant)`` on one scenario: its wall time and ms a tick, its
    trajectory checked; its last state and torques saved to
    :func:`joint_state_file`."""
    import math
    import torch
    spec = JOINT_ROLLOUTS[name]
    cl, jp = port.closed_loop, port.joint_plant
    cfg, pb, terr = joint_env(port, device, name)
    carry = cl.make_standing_start(cfg, pb, terr, height=spec["height"],
                                   plant=jp, device=device)
    joy = cl.joy_schedule(spec["n_steps"], walk_after=spec["walk_after"],
                          velx=spec["velx"], device=device)
    port.kernels.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    carry, trace = cl.rollout(cfg, pb, terr, carry, joy, spec["n_steps"],
                              substeps=JOINT_ROLLOUT_SUBSTEPS, plant=jp,
                              device=device)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: n for k, n in port.kernels.launches.items() if n}
    rp = trace.root_pos[:, 0].cpu().numpy()
    state = {f.name: getattr(carry.ps, f.name)
             for f in dataclasses.fields(carry.ps)}
    joint_state_file(name).parent.mkdir(parents=True, exist_ok=True)
    torch.save(dict(state=state, torques=trace.joint_torques[-1]),
               joint_state_file(name))
    rep = dict(
        **spec, ticks=spec["n_steps"], wall_s=wall,
        ms_per_tick=wall * 1e3 / spec["n_steps"],
        final_pos=rp[-1].tolist(),
        min_z_walking=float(rp[spec["walk_after"] + 200:, 2].min()),
        max_z_walking=float(rp[spec["walk_after"] + 200:, 2].max()),
        nan=bool(not all(math.isfinite(v) for v in rp.flatten())),
        launches=launches)
    log(f"  joint plant {name} ({spec}): {rep['wall_s']:.1f} s, "
        f"{rep['ms_per_tick']:.1f} ms a tick (beside the other protocol "
        f"and phase 6h's checks); final {rep['final_pos']}, z while "
        f"walking {rep['min_z_walking']:.4f}-{rep['max_z_walking']:.4f}; "
        f"kernel launches {launches or 'none'}")
    ok = not rep["nan"]
    if name == "trot":
        ok = ok and (rep["final_pos"][0] > TROT_MIN_X
                     and TROT_Z[0] < rep["min_z_walking"]
                     and rep["max_z_walking"] < TROT_Z[1])
    if not ok:
        raise AssertionError(f"joint plant {name}: {rep}")
    return rep


def joint_step_alone(port, device, name: str) -> dict:
    """``plant_step`` from a protocol's last state and torques, with
    nothing else running: its ms (CUDA events over 20 calls), its host
    reads (the counted ``info`` read and every synchronizing call), and
    the card's operations of one call (torch.profiler's CUDA events:
    kernels, copies and fills), also a substep."""
    import torch
    from torch.autograd import DeviceType
    jp, tensors = port.joint_plant, port.tensors
    cfg, pb, terr = joint_env(port, device, name)
    saved = torch.load(joint_state_file(name), map_location=device)
    ps = jp.JointPlantState(**saved["state"])
    dt = torch.tensor(cfg.control_dt, device=device)
    step = lambda: jp.plant_step(pb, terr, ps, saved["torques"], dt,
                                 JOINT_ROLLOUT_SUBSTEPS)
    step_ms = cuda_ms(step, 20)
    syncs0 = tensors.host_syncs
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            for _ in range(3):
                step()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    with port.profiling.trace(str(TRACE_DIR / f"joint_{name}")) as prof:
        step()
        torch.cuda.synchronize()
    ops = sum(e.count for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA)
    rep = dict(plant_step_ms=step_ms,
               counted_reads_per_step=(tensors.host_syncs - syncs0) / 3,
               synchronizing_calls_per_step=len(caught) / 3,
               sync_sites=sorted({f"{Path(w.filename).name}:{w.lineno}"
                                  for w in caught}),
               device_ops_per_step=ops or None,
               device_ops_per_substep=(ops / JOINT_ROLLOUT_SUBSTEPS
                                       if ops else None))
    log(f"  joint plant {name}: plant_step alone ({JOINT_ROLLOUT_SUBSTEPS} "
        f"substeps, nothing else running) {step_ms:.2f} ms, "
        + (f"{ops} device operations a plant_step "
           f"({ops / JOINT_ROLLOUT_SUBSTEPS:.1f} a substep)" if ops else
           "device operations not measured (the profiler saw none)")
        + f", host reads a plant_step: counted "
        f"{rep['counted_reads_per_step']}, synchronizing calls "
        f"{rep['synchronizing_calls_per_step']} {rep['sync_sites']}")
    return rep


def joint_rollout_main(name: str) -> int:
    """``chip_smoke.py --joint-rollout NAME``: :func:`joint_rollout` in a
    process of its own, its report as the last line."""
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    print(json.dumps(joint_rollout(Port(), torch.device("cuda"), name)),
          flush=True)
    return 0


def phase_joint_plant(port, device) -> dict:
    """The articulated plant on the card: the two closed-loop protocols,
    each in a process of its own (both host-bound on one scenario, so
    they run side by side), while this process holds the plant against
    the port on the CPU and runs the JAX tests' physics; then, once they
    are done, ``plant_step`` alone from each protocol's last state. No
    hand kernel: ``torch.linalg.solve_ex`` and products, as the JAX
    package's XLA solve and dots."""
    t0 = time.perf_counter()
    procs = {name: subprocess.Popen(
        [sys.executable, str(ROOT / "chip_smoke.py"), "--joint-rollout",
         name], cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for name in JOINT_ROLLOUTS}
    try:
        rep = dict(card_vs_cpu=joint_card_vs_cpu(port, device),
                   physics=joint_physics(port, device))
        for name, proc in procs.items():
            out, err = proc.communicate(timeout=JOINT_ROLLOUT_TIMEOUT_S)
            lines = out.strip().splitlines()
            for line in lines[:-1]:
                log(line)
            if proc.returncode != 0:
                raise AssertionError(f"joint plant {name}: rc "
                                     f"{proc.returncode}\n{err[-3000:]}")
            rep[name] = json.loads(lines[-1])
    finally:
        for proc in procs.values():
            proc.kill()
    for name in JOINT_ROLLOUTS:
        rep[name].update(joint_step_alone(port, device, name))
    rep["wall_s"] = time.perf_counter() - t0
    log(f"  phase 6h: {rep['wall_s']:.1f} s")
    return rep


def same_results(port, a, b) -> bool:
    """Every tensor of two result trees bit-equal."""
    import torch
    pairs = []
    port.tensors.tree_map(lambda x, y: pairs.append((x, y)), a, b)
    return all(torch.equal(x, y) for x, y in pairs)


def mesh_dryrun(port, device) -> dict:
    """``entry.dryrun_multichip(1)`` under a NCCL group of one rank, the
    launches counted from 0 just before it and read just after (K1, K2
    and K3 each at least once), then ``dryrun_cases`` without the mesh
    on the same batch: every case's per-scenario results bit-equal."""
    import torch
    import torch.distributed as dist
    k, mesh, entry = port.kernels, port.mesh, port.entry
    rank_device = mesh.multihost_init(mesh.local_coordinator(), 1, 0,
                                      device=device)
    try:
        backend = dist.get_backend()
        k.reset_launches()
        t0 = time.perf_counter()
        out = entry.dryrun_multichip(1, rank_device)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {name: n for name, n in k.launches.items() if n}
    finally:
        dist.destroy_process_group()
    ref = entry.dryrun_cases(1, None, device)
    equal = {key: same_results(port, out[key], ref[key]) for key in (
        "err", "carry_step", "carry_reduced", "carry_amortized",
        "kkt_carry")}
    rep = dict(backend=backend, wall_s=wall, launches=launches,
               bit_equal=equal, mean_err=float(out["mean_err"]))
    log(f"  dryrun_multichip(1) ({backend}): {wall:.1f} s, kernel launches "
        f"{launches}, per-scenario results bit-equal without the mesh "
        f"{equal}")
    if (backend != "nccl" or not all(equal.values())
            or any(launches.get(name, 0) < 1 for name in (K1, K2, K3))):
        raise AssertionError(f"dryrun_multichip: {rep}")
    return rep


def mesh_workers(port, device) -> dict:
    """The port's worker as two processes sharing the card (gloo): both
    ranks print equal ``MULTIHOST_OK`` values, and those equal, within
    ``MESH_REL_TOL``, one process's run of each rank's block in turn,
    reduced on the host."""
    import torch
    port_no = port.mesh.local_coordinator().rsplit(":", 1)[1]
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-m", f"{PKG}.scripts.multihost_worker", str(i),
         "2", port_no] + (["--cpu"] if device.type == "cpu" else []),
        cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for i in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=CLI_TIMEOUT_S)[0])
    finally:
        for p in procs:
            p.kill()
    wall = time.perf_counter() - t0
    for i, (p, out) in enumerate(zip(procs, outs)):
        log(f"  worker {i}: rc {p.returncode}: "
            + " | ".join(out.strip().splitlines()[-5:]))
    if any(p.returncode != 0 or "MULTIHOST_OK" not in out
           for p, out in zip(procs, outs)):
        raise AssertionError("multihost workers failed:\n"
                             + "\n".join(o[-2000:] for o in outs))
    vals = [out.split("MULTIHOST_OK")[1].split()[:3] for out in outs]
    blocks = [port.multihost_worker.block_torques(i, 2, device)
              for i in range(2)]
    ref = [float(torch.cat([b[name] for b in blocks]).abs().double().mean())
           for name in ("xla", "production", "amortized")]
    rel = [abs(float(v) - r) / abs(r) for v, r in zip(vals[0], ref)]
    rep = dict(wall_s=wall, ranks=vals, one_process=ref, rel=rel,
               backend=("gloo" if "backend=gloo" in outs[0] else "?"))
    log(f"  workers (2 ranks, one card): {wall:.1f} s, MULTIHOST_OK "
        f"{vals}, one process in turn {ref}, relative {rel}")
    if vals[0] != vals[1] or max(rel) > MESH_REL_TOL \
            or rep["backend"] != "gloo":
        raise AssertionError(f"multihost workers: {rep}")
    return rep


def phase_mesh(port, device) -> dict:
    return dict(dryrun=mesh_dryrun(port, device),
                workers=mesh_workers(port, device))


def kernel_entry(name, source, replaces, rows, launches, lib):
    """The kernels line's entry: the headline shape's numbers (the first
    row), every other shape beside them."""
    head = rows[0]
    return dict(
        name=name, route="cuda", source=f"{PKG}/csrc/{source}",
        replaces=replaces, launches=launches[name],
        max_abs_err=max(r["err"] for r in rows), ms=head["ms"],
        plain_ms=head["plain_ms"], bound_ms=head["bound_ms"],
        bound_by=head["bound_by"], library_ms=head["lib_ms"] if lib else None,
        shape={key: v for key, v in head.items()
               if key in ("b", "n", "m", "iters")},
        other_shapes=[{key: v for key, v in r.items() if key != "err"}
                      for r in rows[1:]])


def script_entries(rows, scripts) -> list:
    """The kernels line's S1 and S2a-c entries: S1 headed by 'full' at
    unroll 1, each ladder by its heaviest probe (the grid negate for
    S2c); launches from each script's own run."""
    def entry(name, source, replaces, rws, head, launches, **extra):
        rws = [rws[head]] + rws[:head] + rws[head + 1:]
        h = rws[0]
        keys = ("variant", "unroll", "b", "n", "m", "iters", "probe",
                "body", "shape", "steps")
        return dict(
            name=name, route="cuda", source=f"{PKG}/csrc/{source}",
            replaces=replaces, launches=launches,
            max_abs_err=max(r["err"] for r in rws), ms=h["ms"],
            plain_ms=h["plain_ms"], bound_ms=h["bound_ms"],
            bound_by=h["bound_by"], library_ms=h["lib_ms"],
            shape={k: v for k, v in h.items() if k in keys},
            other_shapes=[{k: v for k, v in r.items()
                           if k not in ("err", "check")} for r in rws[1:]],
            **extra)

    launch = lambda script: scripts[script]["launches"].get(
        S1 if script == "micro_admm" else S2, 0)
    heaviest = lambda rws: max(range(len(rws)),
                               key=lambda i: rws[i]["bound_ms"])
    s2 = rows[S2]
    return [
        entry("S1 micro_admm", "micro_admm.cu", f"{SCRIPTS}/micro_admm.py:102",
              rows[S1], 0, launch("micro_admm"), launches_route="micro_admm"),
        entry("S2a mosaic_probes (probe_mosaic)", "mosaic_probes.cu",
              f"{SCRIPTS}/probe_mosaic.py:33", s2["probe_mosaic"],
              heaviest(s2["probe_mosaic"]), launch("probe_mosaic"),
              launches_route="probe_mosaic",
              odd_shape_cases_bit_equal=s2["odd_cases"]),
        entry("S2b mosaic_probes (probe_mosaic2)", "mosaic_probes.cu",
              f"{SCRIPTS}/probe_mosaic2.py:28", s2["probe_mosaic2"],
              heaviest(s2["probe_mosaic2"]), launch("probe_mosaic2"),
              launches_route="probe_mosaic2"),
        entry("S2c mosaic_probes (probe_mosaic4 grid negate)",
              "mosaic_probes.cu", f"{SCRIPTS}/probe_mosaic4.py:32",
              s2["probe_mosaic4"], 0, launch("probe_mosaic4"),
              launches_route="probe_mosaic4"),
    ]


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not (ROOT / PKG / "csrc").is_dir():
        print(f"chip_smoke: {PKG}/ not found beside this script",
              file=sys.stderr)
        return 1
    device = torch.device("cuda")
    t_start = time.perf_counter()

    log("[1] device")
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    log(f"  {card}; torch {torch.__version__} cuda {torch.version.cuda}")

    log("[2] build")
    port = Port()
    t0 = time.perf_counter()
    libs = port.kernels.build_kernels()
    log(f"  built {sorted(libs)} in {time.perf_counter() - t0:.1f} s")
    for name, text in port.kernels.build_log.items():
        for line in text.splitlines():
            if any(key in line for key in ("Function properties",
                                           "registers", "spill", "smem")):
                log(f"  ptxas {name}: {line.strip()}")
    occupancy = {n: port.kernels.inverse_reg_occupancy(n)
                 for n in (32, 64, 66, 120)}
    log(f"  inverse_t register kernel (K1, K3) by n: blocks resident per "
        f"SM (occupancy calculator), registers, spill bytes: {occupancy}")
    rank_occupancy = {
        f"{label} r={k} n={n}": port.kernels_retired.rank_reg_occupancy(
            n, k, masked)
        for label, masked, ranks in (("K6d", False, K6D_RANKS),
                                     ("K6e", True, K6E_RANKS))
        for k in ranks for n in (32, 120)}
    log(f"  gj_rank register tile (K6d, K6e): blocks resident per SM, "
        f"registers, spill bytes: {rank_occupancy}")
    # K2's register tiers at the route's full-size and reduced-tier shapes
    k2_occupancy = {
        f"n={n} m={m}": port.kernels.fused_admm_shared_occupancy(n, m)
        for n, m in ((120, 200), (66, 110))}
    log(f"  fused_admm_shared register tiers (K2): blocks resident per SM, "
        f"registers, spill bytes: {k2_occupancy}")
    if any(v["local_bytes"] for v in k2_occupancy.values()):
        raise AssertionError(f"K2's register tiers spill: {k2_occupancy}")
    # K5's register tier (P = 8, 16, 32; the hybrid's p = 30) and its
    # shared-memory tier past it
    k5_occupancy = {p: port.kernels.chol_linv_occupancy(p)
                    for p in (8, 16, 30, 64)}
    log(f"  chol_linv tiers (K5) by p: blocks resident per SM, registers, "
        f"spill bytes: {k5_occupancy}")
    if any(v["local_bytes"] for p, v in k5_occupancy.items()
           if p <= K5_REG_MAX):
        raise AssertionError(f"K5's register tier spills: {k5_occupancy}")

    log("[3] kernels vs plain")
    rows = phase_kernels(port, device)

    log("[4] routes")
    routes, gj_counts, warm_s, ticks, profile = phase_routes(port, device)
    small = phase_small(port, device)

    log("[5a] the scripts")
    scripts = phase_scripts(port, device)
    log("[5b] S1 micro_admm vs plain")
    rows[S1] = s1_rows(port, device, scripts)
    log("[5c] S2 mosaic_probes vs plain")
    rows[S2] = s2_rows(port, device, scripts)

    log("[6a] stand-QP route")
    stand = phase_stand(port, device)
    log("[6b] stand-QP card vs CPU")
    small_stand = phase_small_stand(port, device)
    log("[6c] stand gate")
    gate = phase_gate(port, device)
    log("[6d] MPC golden gates")
    golden = phase_golden(port, device)
    log("[6e] terrain evaluation")
    terrain = phase_terrain(port, device)
    log("[6f] dual-rate schedule")
    dual_rate = phase_dual_rate(port, device)
    log("[6g] runtime and CLI")
    runtime = phase_runtime(port, device)
    log("[6h] articulated plant")
    joint = phase_joint_plant(port, device)
    log("[6i] mesh")
    mesh = phase_mesh(port, device)

    log("[7] kernels")
    # each kernel's launches on the path it is read for: K1/K2 on the
    # bench's first candidate, K3 on the reduced tier, K4 on the legacy
    # route, K6g and the sweep on their routes, K5 in the hybrid inverse
    # of the KKT batch (no route calls it, as in the JAX package); every
    # route's counts beside them
    main_route = {K1: "amortized", K2: "amortized", K3: "reduced_tier",
                  K4: "pallas", K5: "spd_cholesky_inverse_hybrid",
                  K6G: "gj_t", K6S: "sweep_t", K6B: "components",
                  K6C: "components", K6D: "components", K6E: "components",
                  K6F: "components"}
    launches = {name: routes[r]["launches"][name]
                for name, r in main_route.items() if r in routes}
    launches[K5] = rows["k5_path_launches"]
    launches.update({name: profile["launches"][name]
                     for name in (K6B, K6C, K6D, K6E, K6F)})
    kernels = [
        kernel_entry(K1, "inverse_t.cu", f"{PALLAS}:96", rows[K1], launches,
                     True),
        kernel_entry(K2, "fused_admm_shared.cu", f"{PALLAS}:428", rows[K2],
                     launches, False),
        kernel_entry(K3, "inverse_t.cu", f"{PALLAS}:126", rows[K3],
                     launches, True),
        kernel_entry(K4, "fused_admm.cu", f"{PALLAS}:275", rows[K4],
                     launches, False),
        kernel_entry(K5, "chol_linv.cu", f"{PALLAS}:212", rows[K5], launches,
                     True),
        kernel_entry(K6G, "inverse_t.cu", f"{RETIRED}:564", rows[K6G],
                     launches, True),
        kernel_entry(K6S, "inverse_t.cu", f"{RETIRED}:741", rows[K6S],
                     launches, True),
        kernel_entry(K6B, "inverse_t.cu", f"{RETIRED}:144", rows[K6B],
                     launches, True),
        kernel_entry(K6C, "inverse_t.cu", f"{RETIRED}:213", rows[K6C],
                     launches, True),
        kernel_entry(K6D, "gj_rank.cu", f"{RETIRED}:428", rows[K6D],
                     launches, True),
        kernel_entry(K6E, "gj_rank.cu", f"{RETIRED}:397", rows[K6E],
                     launches, True),
        kernel_entry(K6F, "inverse_t.cu", f"{RETIRED}:489", rows[K6F],
                     launches, True),
    ]
    for entry in kernels:
        entry["launches_route"] = main_route[entry["name"]]
        entry["launches_by_route"] = dict(
            {r: m["launches"][entry["name"]] for r, m in routes.items()},
            gj_warmup=gj_counts[entry["name"]],
            components=profile["launches"][entry["name"]])
        if entry["name"] in golden["amortized"]["launches"]:
            entry["launches_by_route"]["amortized_gate"] = \
                golden["amortized"]["launches"][entry["name"]]
        if entry["name"] in mesh["dryrun"]["launches"]:
            entry["launches_by_route"]["dryrun_multichip"] = \
                mesh["dryrun"]["launches"][entry["name"]]
    kernels[4]["launches_by_route"][main_route[K5]] = launches[K5]
    kernels[1]["occupancy_per_sm"] = k2_occupancy
    kernels[2]["occupancy_per_sm"] = occupancy
    # K6a has no kernel of its own: K3 at its base (4 launches a tick on
    # 'schur'), products in torch.matmul
    kernels[2]["serves"] = {"K6a spd_block_inverse": dict(
        replaces=f"{RETIRED}:41", **rows["k6a"])}
    kernels[4]["hybrid"] = rows["hybrid"]
    kernels[4]["occupancy_per_sm"] = k5_occupancy
    kernels[5]["designs_in_turns"] = rows["k6_designs"]
    for entry, label in ((kernels[9], "K6d"), (kernels[10], "K6e")):
        entry["occupancy_per_sm"] = {
            key: v for key, v in rank_occupancy.items()
            if key.startswith(label)}
        entry["designs_in_turns"] = {
            key: v for key, v in rows["rank_designs"]["ms"].items()
            if key.startswith(label) or key == "torch.linalg.inv"}
    kernels[6]["shared_by"] = {
        "K6h batched_inverse_sweep_T": f"{RETIRED}:902",
        "K6i batched_inverse_sweep_T_chunked": f"{RETIRED}:638",
        "K6k batched_inverse_sweep_T_masked2": f"{RETIRED}:824"}
    # K6j (_masked) and K6k (_masked2) on the probes' reference KKT batch
    kernels[6]["probes"] = {
        name: dict(scripts[name]["result"],
                   launches=scripts[name]["launches"].get(K6S, 0))
        for name in ("probe_mosaic3", "probe_mosaic4")}
    kernels += script_entries(rows, scripts)
    log(json.dumps({"routes": routes, "small": small, "warm_s": warm_s,
                    "control_tick": ticks, "components": profile["rows"],
                    "f32_product_rel": rows["f32_product_rel"],
                    "stand": stand, "small_stand": small_stand,
                    "stand_gate": gate, "golden_gates": golden,
                    "terrain_eval": terrain, "dual_rate": dual_rate,
                    "runtime": runtime, "joint_plant": joint,
                    "mesh": mesh,
                    "seconds": time.perf_counter() - t_start}))
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--joint-rollout"]:
        sys.exit(joint_rollout_main(sys.argv[2]))
    sys.exit(main())
