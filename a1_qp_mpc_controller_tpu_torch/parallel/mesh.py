"""Scenario mesh over ``torch.distributed`` (counterpart of
``parallel/mesh.py``).

The scaling axis is the scenario batch: domain-randomized robots split
over the ranks, each rank solving its own block, with collectives only
for the metric reductions and no per-solve communication. PyTorch runs
one process a device where JAX runs one process over many, so the mesh
is a ``DeviceMesh`` over the ranks: 1-D ``("scenario",)``, or
``("host", "scenario")`` at (nodes x local ranks).

- Every rank builds the same global batch from the seed and keeps its
  contiguous block of the leading axis (:func:`shard_batch`); a batch
  that the ranks do not divide raises. Trees every rank holds whole
  (the controller config, a joystick command) are passed as they are.
- A rank runs a route on its block alone, so the amortized and reduced
  routes size their pools per shard, as the JAX ``shard_map`` does: a
  shard's result is the route run on that shard, not a slice of the
  unsharded batch's.
- Metrics equal the global ones: a mean is an all-reduce of sums and
  counts (:func:`mean`), a max an all-reduce MAX (:func:`amax`), and a
  percentile is taken over the values gathered from every rank
  (:func:`gather`). On a 2-D mesh each reduction runs over the scenario
  group first, then over the host group.

The process group is NCCL where each local rank has a card of its own
and gloo otherwise: on the CPU, and where ranks share a card (NCCL
refuses two ranks on one device). A gloo group's values go through the
host. ``mesh=None`` everywhere means one process: the helpers then
reduce locally.
"""

from __future__ import annotations

import datetime
import os
import socket

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from a1_qp_mpc_controller_tpu_torch.tensors import (
    CUDA, resolve_device, tree_map,
)

SCENARIO_AXIS = "scenario"
HOST_AXIS = "host"
TIMEOUT = datetime.timedelta(minutes=10)


def default_backend(device, local_ranks: int) -> str:
    """NCCL when ``device`` is a card and each of this host's
    ``local_ranks`` ranks has a card of its own; gloo otherwise."""
    device = torch.device(device)
    if device.type == "cuda" and local_ranks <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def multihost_init(coordinator_address: str | None = None,
                   num_processes: int | None = None,
                   process_id: int | None = None, *,
                   local_ranks: int | None = None,
                   device=CUDA) -> torch.device | None:
    """Join this process to the run's process group; call it before any
    tensor is made.

    With explicit arguments (coordinator ``host:port``, process count,
    process id) this must succeed: ``init_process_group`` over
    ``tcp://``, a bad cluster raises. ``local_ranks`` is the number of
    ranks on this host (default: every rank, a one-host cluster). With
    no arguments, a launcher's ``RANK`` and ``WORLD_SIZE`` (``torchrun``)
    select ``env://``; without them this does nothing (one process).
    The backend is :func:`default_backend`'s. Returns this rank's device,
    made the current one (on a card, ``cuda:<local rank modulo the
    cards>``), for the caller to make its tensors on; None where no group
    is initialized."""
    device = resolve_device(device)
    if coordinator_address is not None:
        if num_processes is None or process_id is None:
            raise ValueError("a coordinator address needs num_processes "
                             "and process_id")
        local = num_processes if local_ranks is None else local_ranks
        rank_device = _bind(device, process_id % local)
        dist.init_process_group(
            default_backend(device, local),
            init_method=f"tcp://{coordinator_address}",
            world_size=num_processes, rank=process_id, timeout=TIMEOUT)
        return rank_device
    if dist.is_initialized():
        return (torch.device("cuda", torch.cuda.current_device())
                if device.type == "cuda" else device)
    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        return None
    local = int(os.environ.get("LOCAL_WORLD_SIZE",
                               os.environ["WORLD_SIZE"]))
    rank_device = _bind(
        device, int(os.environ.get("LOCAL_RANK", os.environ["RANK"])))
    dist.init_process_group(default_backend(device, local),
                            init_method="env://", timeout=TIMEOUT)
    return rank_device


def local_coordinator() -> str:
    """``127.0.0.1:<a free port>``: the coordinator of a one-host run."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return f"127.0.0.1:{s.getsockname()[1]}"


def _bind(device: torch.device, local_rank: int) -> torch.device:
    """The rank's device with its index, made the current device, so that
    an index-less ``"cuda"`` (and ``tensors.const``'s cache under it) is
    this rank's card too."""
    if device.type != "cuda":
        return device
    rank_device = torch.device("cuda",
                               local_rank % torch.cuda.device_count())
    torch.cuda.set_device(rank_device)
    return rank_device


def _mesh_device_type() -> str:
    """A NCCL group's mesh lives on the cards; a gloo group's on the CPU
    (its collectives run on host copies)."""
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_mesh(axis_name: str = SCENARIO_AXIS) -> DeviceMesh:
    """1-D mesh over every rank of the initialized process group."""
    return init_device_mesh(_mesh_device_type(), (dist.get_world_size(),),
                            mesh_dim_names=(axis_name,))


def make_host_chip_mesh(local_ranks: int | None = None,
                        axis_names=(HOST_AXIS, SCENARIO_AXIS)) -> DeviceMesh:
    """2-D (hosts x local ranks) mesh: the batch splits over both axes
    (each rank still owns one block), and keeping the host axis explicit
    lets a reduction run inside each host before the one small reduction
    across hosts. ``local_ranks`` defaults to ``LOCAL_WORLD_SIZE`` or,
    without it, every rank (one host: (1, n))."""
    world = dist.get_world_size()
    local = local_ranks or int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if world % local:
        raise ValueError(f"{world} ranks do not split into hosts of {local}")
    return init_device_mesh(_mesh_device_type(), (world // local, local),
                            mesh_dim_names=tuple(axis_names))


def block(mesh: DeviceMesh | None) -> tuple[int, int]:
    """(this rank's block index, the number of blocks) in the mesh's
    row-major order; (0, 1) without a mesh."""
    if mesh is None:
        return 0, 1
    ranks = mesh.mesh.flatten().tolist()
    return ranks.index(dist.get_rank()), len(ranks)


def take_block(tree, idx: int, count: int):
    """Block ``idx`` of ``count`` contiguous blocks of every leaf's
    leading (scenario) axis, as copies; a batch that ``count`` does not
    divide raises."""
    def one(a):
        n = a.shape[0]
        if n % count:
            raise ValueError(f"a batch of {n} does not split over "
                             f"{count} ranks")
        k = n // count
        return a[idx * k:(idx + 1) * k].clone()
    return tree_map(one, tree)


def shard_batch(tree, mesh: DeviceMesh | None):
    """This rank's block of every leaf's leading (scenario) axis; the
    identity without a mesh."""
    return tree if mesh is None else take_block(tree, *block(mesh))


def _groups(mesh: DeviceMesh):
    """The mesh's process groups, innermost axis first."""
    return [mesh.get_group(name) for name in reversed(mesh.mesh_dim_names)]


def _collective(x: torch.Tensor, group, op) -> torch.Tensor:
    """``op(buffer, group)`` on a copy of ``x``, through the host for a
    gloo group; the result on ``x``'s device."""
    host = dist.get_backend(group) == "gloo" and x.device.type != "cpu"
    buf = x.detach().to("cpu", copy=True) if host else x.detach().clone()
    out = op(buf, group)
    return out.to(x.device)


def _all_reduce(x: torch.Tensor, mesh: DeviceMesh, op) -> torch.Tensor:
    def run(buf, group):
        dist.all_reduce(buf, op=op, group=group)
        return buf
    for group in _groups(mesh):
        x = _collective(x, group, run)
    return x


def mean(x: torch.Tensor, mesh: DeviceMesh | None) -> torch.Tensor:
    """Mean of every element of ``x`` over every rank: the sum (in
    float64) and the count all-reduced; ``x.mean()`` without a mesh."""
    if mesh is None:
        return x.mean()
    sc = torch.stack([x.double().sum(),
                      torch.full((), x.numel(), dtype=torch.float64,
                                 device=x.device)])
    sc = _all_reduce(sc, mesh, dist.ReduceOp.SUM)
    return (sc[0] / sc[1]).to(x.dtype)


def amax(x: torch.Tensor, mesh: DeviceMesh | None) -> torch.Tensor:
    """Largest element of ``x`` over every rank."""
    m = x.amax()
    return m if mesh is None else _all_reduce(m, mesh, dist.ReduceOp.MAX)


def gather(x: torch.Tensor, mesh: DeviceMesh | None) -> torch.Tensor:
    """Every rank's ``x`` concatenated along dim 0 in rank order (the
    global batch when ``x`` is this rank's block)."""
    if mesh is None:
        return x

    def run(buf, group):
        parts = [torch.empty_like(buf)
                 for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, buf.contiguous(), group=group)
        return torch.cat(parts)
    for group in _groups(mesh):
        x = _collective(x, group, run)
    return x
