"""Data and point parallelism over a ``torch.distributed`` device mesh (port
of ``dl_biomass_tpu/parallel/mesh.py``).

The JAX package runs SPMD over a ``(dp, mp)`` mesh: the batch axis is sharded
over ``dp`` (``P("dp")``), and a batch placed with ``P("dp", "mp", None)``
also has each cloud's points sharded over ``mp``; XLA inserts the sums and
gathers that make the sharded step compute what the whole batch gives on one
device. Here each mesh coordinate is a process (a rank) and the sums are
written out:

  * ``shard_batch``: a rank takes its ``dp`` slice of the whole batch; ranks
    that share a ``dp`` coordinate take the same slice;
  * ``sum_dp``: a sum over the ``dp`` group (differentiable with
    ``grad=True``: its backward sums the cotangents over the group), for the
    BatchNorm statistics, kernel 6's column sums, the loss's count and the
    gradients;
  * ``gather_dp``: every rank's rows, in batch order, on every rank, written
    as a sum of zero-filled buffers (one ``all_reduce``; on the bits of the
    rows, so that the gathered values are the rows, bit for bit);
  * ``rand_rows``: a draw of ``torch.rand`` for the whole batch from the
    shared generator, of which a rank keeps its rows: the FPS starts and the
    dropout are those of one process on the whole batch (the ``mp`` ranks of
    one ``dp`` slice draw the same rows);
  * ``shard_points``: a rank's ``dp`` slice of the clouds and its ``mp``
    slice of each cloud's points; ``gather_points`` and ``gather_mp`` bring
    the ``mp`` slices together (the latter differentiably: its backward sums
    the cotangents over ``mp`` and keeps this rank's rows);
  * ``sum_stats``: the BatchNorm statistics' sums over the ranks that share
    the rows: the ``dp`` group, or the whole mesh inside ``split_rows()``,
    where each ``mp`` rank holds its share of a layer's centroids.

The layers learn of the mesh from ``data_parallel(mesh, points=)``, a
context that ``Trainer`` and the serving engines enter around their forwards
and backwards; without it every path is the one-process path, unchanged.
``points=True`` (``Trainer.step``, ``evaluate``, ``predict`` under ``mp`` >
1) tells the model that each rank holds its ``mp`` slice of the points; the
serving engines and the trainer's epochs over a ``DeviceDataset`` leave it
off and run replicated over ``mp``, as the JAX package shards only ``dp``
there. The mesh needs only ``all_reduce``, ``broadcast`` and groups, which
gloo also takes on CUDA tensors: ``backend_for`` takes nccl where each rank
has a card of its own and gloo where ranks share a card or run on the CPU.

A run under ``torchrun`` calls ``init_from_env``; ``spawn`` starts ``world``
ranks on this machine from a file store (``init_method="file://..."``).
"""

from __future__ import annotations

import contextlib
import os
from typing import Callable, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

AXES = ("dp", "mp")
# a collective of spawned ranks that waits longer than this raises: a rank
# that died must not leave the others waiting
COLLECTIVE_TIMEOUT_S = 600

_active = None  # the mesh of the enclosing data_parallel(), read by the layers
_points = False  # each rank of _active holds its mp slice of every cloud's points
_split = False  # the enclosed layers' rows are this rank's mp share (split_rows)
_mesh_groups = {}  # the ranks of a mesh built by make_mesh -> a group over all of them


def mesh_shape(world: int, dp: int = -1, mp: int = 1) -> Tuple[int, int]:
    """The ``(dp, mp)`` of a mesh over ``world`` ranks, by the JAX package's
    rules: ``dp=-1`` takes every remaining rank; a rank count ``mp`` does not
    divide, or ``dp * mp`` beyond the world, raises ``ValueError``."""
    if dp == -1:
        if world % mp != 0:
            raise ValueError(f"{world} ranks not divisible by mp={mp}")
        dp = world // mp
    if dp < 1 or mp < 1:
        raise ValueError(f"mesh ({dp}x{mp}) needs positive axes")
    if dp * mp > world:
        raise ValueError(f"mesh ({dp}x{mp}) larger than rank count {world}")
    return dp, mp


def backend_for(device: torch.device, local_world: int) -> str:
    """nccl where each of the ``local_world`` ranks on this machine has a card
    of its own; gloo where they share a card or run on the CPU."""
    if device.type == "cuda" and torch.cuda.device_count() >= local_world:
        return "nccl"
    return "gloo"


def rank_device(device, local_rank: int, local_world: int) -> torch.device:
    """The device of a rank: ``cuda:<local rank>`` where every rank has a
    card of its own, ``cuda:0`` where they share one, or the CPU."""
    from dl_biomass_tpu_torch.core.cloud import resolve_device

    dev = resolve_device(device)
    if dev.type != "cuda":
        return dev
    index = local_rank if torch.cuda.device_count() >= local_world else 0
    torch.cuda.set_device(index)
    return torch.device("cuda", index)


def init_from_env(device=None) -> torch.device:
    """Join the process group that ``torchrun`` describes (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR``,
    ``MASTER_PORT``) unless one is joined already; returns this rank's device
    (``device=None``: the card)."""
    local_rank = int(os.environ.get("LOCAL_RANK", 0))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", os.environ.get("WORLD_SIZE", 1)))
    dev = rank_device(device, local_rank, local_world)
    if not dist.is_initialized():
        dist.init_process_group(backend_for(dev, local_world), init_method="env://")
    return dev


def make_mesh(dp: int = -1, mp: int = 1, device=None):
    """A ``DeviceMesh`` with axes ``("dp", "mp")`` over the first ``dp * mp``
    ranks of the default process group (``mesh_shape``'s rules); every rank
    of the group calls it. ``device`` (None: the card) names the device
    type."""
    from torch.distributed.device_mesh import DeviceMesh

    from dl_biomass_tpu_torch.core.cloud import resolve_device

    dp, mp = mesh_shape(dist.get_world_size(), dp, mp)
    mesh = DeviceMesh(resolve_device(device).type, torch.arange(dp * mp).view(dp, mp),
                      mesh_dim_names=AXES)
    if mp > 1:  # the whole mesh's sums (statistics, gradients) need a group of their own
        _mesh_groups[_ranks(mesh)] = dist.new_group(list(range(dp * mp)))
    return mesh


def _ranks(mesh) -> Tuple[int, ...]:
    return tuple(mesh.mesh.flatten().tolist())


# ---- the mesh in use --------------------------------------------------------


@contextlib.contextmanager
def data_parallel(mesh, points: bool = False):
    """Run the enclosed forwards and backwards over ``mesh`` (None: one
    process); ``points=True``: each rank holds its ``mp`` slice of every
    cloud's points (``shard_points``). Plain globals, not context variables:
    autograd runs a CUDA backward on a thread of its own."""
    with restored((mesh, bool(points) and mesh is not None and mp_size(mesh) > 1, False)):
        yield mesh


@contextlib.contextmanager
def restored(state):
    """Run the enclosed code in a ``state()`` taken earlier (a recompute in
    the backward runs in its forward's)."""
    global _active, _points, _split
    prev = (_active, _points, _split)
    _active, _points, _split = state
    try:
        yield
    finally:
        _active, _points, _split = prev


def state():
    """(mesh, points, split) of the enclosing contexts."""
    return _active, _points, _split


@contextlib.contextmanager
def split_rows():
    """The enclosed layers run on this rank's ``mp`` share of the rows: their
    statistics are summed over the whole mesh (``sum_stats``)."""
    with restored((_active, _points, True)):
        yield


def active():
    """The mesh of the enclosing ``data_parallel``, or None."""
    return _active


def point_parts() -> int:
    """How many ``mp`` slices the enclosing ``data_parallel`` splits each
    cloud's points into (1: every rank holds whole clouds)."""
    return mp_size(_active) if _points else 1


def _coordinate(mesh) -> Tuple[int, ...]:
    coord = mesh.get_coordinate()
    if coord is None:
        raise RuntimeError(f"rank {dist.get_rank()} holds no place in the mesh {mesh}")
    return tuple(coord)


def dp_size(mesh) -> int:
    return mesh.size(0)


def dp_rank(mesh) -> int:
    """This rank's coordinate on the ``dp`` axis: its slice of a batch."""
    return _coordinate(mesh)[0]


def mp_size(mesh) -> int:
    return mesh.size(1)


def mp_rank(mesh) -> int:
    """This rank's coordinate on the ``mp`` axis: its slice of each cloud's
    points, and its share of each split layer's centroids."""
    return _coordinate(mesh)[1]


def mesh_group(mesh):
    """The group of every rank of ``mesh`` (its ``dp`` group where ``mp`` is 1)."""
    if mp_size(mesh) == 1:
        return mesh.get_group("dp")
    try:
        return _mesh_groups[_ranks(mesh)]
    except KeyError:
        raise ValueError("a mesh with mp > 1 must come from make_mesh") from None


def is_writer(mesh) -> bool:
    """Whether this rank writes the run's files: rank 0, or any rank without
    a mesh."""
    return mesh is None or dist.get_rank() == 0


def dp_slice(n: int, mesh) -> slice:
    """The rows of a batch of ``n`` this rank takes; ``n`` must split evenly
    over the ``dp`` axis."""
    d = dp_size(mesh)
    if n % d:
        raise ValueError(f"a batch of {n} clouds does not split over the mesh's dp={d} "
                         "ranks: the batch must be a multiple of dp")
    b = n // d
    r = dp_rank(mesh)
    return slice(r * b, (r + 1) * b)


def shard_batch(batch, mesh):
    """This rank's ``dp`` slice of a ``CloudBatch`` (the batch itself without
    a mesh)."""
    if mesh is None:
        return batch
    s = dp_slice(batch.pos.shape[0], mesh)
    return type(batch)(pos=batch.pos[s], feat=batch.feat[s], mask=batch.mask[s],
                       y=None if batch.y is None else batch.y[s])


def shard_points(batch, mesh):
    """This rank's ``dp`` slice of a ``CloudBatch`` with its ``mp`` slice of
    each cloud's points (the targets are the clouds'): the counterpart of
    placing the batch with ``P("dp", "mp", None)``. A point count the ``mp``
    size does not divide raises ``ValueError``."""
    if mesh is None:
        return batch
    s = dp_slice(batch.pos.shape[0], mesh)
    n, parts = batch.pos.shape[1], mp_size(mesh)
    if n % parts:
        raise ValueError(f"clouds of {n} points do not split over the mesh's mp={parts} "
                         "ranks: the point count must be a multiple of mp")
    q = n // parts
    p = slice(mp_rank(mesh) * q, (mp_rank(mesh) + 1) * q)
    return type(batch)(pos=batch.pos[s, p], feat=batch.feat[s, p], mask=batch.mask[s, p],
                       y=None if batch.y is None else batch.y[s])


def rand_rows(shape: Sequence[int], generator: Optional[torch.Generator],
              device) -> torch.Tensor:
    """``torch.rand(shape)`` of this rank's rows: under a mesh the draw is made
    for the whole batch (``shape[0]`` times the ``dp`` size, batch-major rows)
    and this rank keeps its slice, so every rank's generator moves as one
    process's does on the whole batch."""
    mesh = _active
    if mesh is None:
        return torch.rand(tuple(shape), generator=generator, device=device)
    rows = shape[0]
    full = torch.rand((rows * dp_size(mesh), *shape[1:]), generator=generator, device=device)
    r = dp_rank(mesh)
    return full[r * rows:(r + 1) * rows]


# ---- collectives ----------------------------------------------------------------


class _SumDP(torch.autograd.Function):
    """A sum over a group whose backward sums the cotangents over the group:
    each rank's loss depends on every rank's summand."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        t = t.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(t, group=group)
        return t

    @staticmethod
    def backward(ctx, g):
        return _SumDP.apply(g, ctx.group), None


def _sum_over(t: torch.Tensor, group, grad: bool) -> torch.Tensor:
    if grad:
        return _SumDP.apply(t, group)
    t = t.detach().clone(memory_format=torch.contiguous_format)
    dist.all_reduce(t, group=group)
    return t


def sum_dp(t: torch.Tensor, mesh, *, grad: bool = False) -> torch.Tensor:
    """The sum of ``t`` over the ``dp`` group of ``mesh`` (``t`` itself
    without one), a new tensor; ``grad=True`` keeps it differentiable."""
    if mesh is None:
        return t
    return _sum_over(t, mesh.get_group("dp"), grad)


def sum_stats(t: torch.Tensor, *, grad: bool = False) -> torch.Tensor:
    """A BatchNorm statistic's sum over the ranks that share its rows under
    the enclosing ``data_parallel``: the ``dp`` group, or inside
    ``split_rows()`` the whole mesh (``t`` itself without a mesh)."""
    mesh = _active
    if mesh is None:
        return t
    return _sum_over(t, mesh_group(mesh) if _split else mesh.get_group("dp"), grad)


_BITS = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


def gather_slices(local: torch.Tensor, index: int, parts: int, group) -> torch.Tensor:
    """The ``parts`` equal slices (dim 0) of every rank of ``group``, rank
    ``index``'s at its place, on every rank: a zero-filled buffer with this
    rank's rows written in, summed over the group on its bits (floats of 4
    and 8 bytes as integers of their width: each slot holds one rank's value
    and zeros, so the sum is that value's bits)."""
    n = local.shape[0]
    buf = local.new_zeros((n * parts, *local.shape[1:]))
    buf[index * n:(index + 1) * n] = local
    if local.is_floating_point() and local.element_size() in (4, 8):
        bits = buf.view(_BITS[local.element_size()])
        dist.all_reduce(bits, group=group)
        return buf
    if local.dtype == torch.bool:
        out = buf.to(torch.uint8)
        dist.all_reduce(out, group=group)
        return out.bool()
    dist.all_reduce(buf, group=group)
    return buf


def gather_dp(local: torch.Tensor, mesh) -> torch.Tensor:
    """The rows of every ``dp`` slice, in batch order, on every rank (the
    local rows themselves without a mesh)."""
    if mesh is None:
        return local
    return gather_slices(local, dp_rank(mesh), dp_size(mesh), mesh.get_group("dp"))


def gather_points(local: torch.Tensor, mesh) -> torch.Tensor:
    """Every ``mp`` slice of the points (dim 1) in order, bit for bit, on
    every ``mp`` rank: the whole clouds of this rank's ``dp`` slice."""
    whole = gather_slices(local.transpose(0, 1).contiguous(), mp_rank(mesh), mp_size(mesh),
                          mesh.get_group("mp"))
    return whole.transpose(0, 1).contiguous()


class _GatherMP(torch.autograd.Function):
    """``gather_points`` trimmed to ``total`` rows; the backward sums the
    cotangents of every ``mp`` rank and keeps this rank's rows."""

    @staticmethod
    def forward(ctx, local, mesh, total):
        ctx.mesh, ctx.rows = mesh, local.shape[1]
        return gather_points(local, mesh)[:, :total].contiguous()

    @staticmethod
    def backward(ctx, g):
        mesh, rows = ctx.mesh, ctx.rows
        whole = g.new_zeros((g.shape[0], rows * mp_size(mesh), *g.shape[2:]))
        whole[:, :g.shape[1]] = g
        dist.all_reduce(whole, group=mesh.get_group("mp"))
        r = mp_rank(mesh)
        return whole[:, r * rows:(r + 1) * rows].contiguous(), None, None


def gather_mp(local: torch.Tensor, mesh, total: int) -> torch.Tensor:
    """The rows (dim 1) of every ``mp`` rank's share, in order, the first
    ``total`` of them, on every ``mp`` rank; differentiable (``_GatherMP``)."""
    return _GatherMP.apply(local, mesh, total)


def sum_grads(params, mesh) -> None:
    """Sum every parameter's ``.grad`` over the whole mesh, in place, in one
    flat buffer (a missing gradient counts as 0). Under ``mp`` > 1 every rank
    backpropagates its loss over the ``mp`` size, so that the replicated
    layers' gradients, summed over ``mp``, count the loss once."""
    params = [p for p in params if p.requires_grad]
    grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=mesh_group(mesh))
    for p, g in zip(params, flat.split([g.numel() for g in grads])):
        p.grad = g.view_as(p).to(p.dtype)


def broadcast_tensors(tensors, src: int = 0) -> None:
    """Copy rank ``src``'s values of ``tensors`` into every rank's, in place."""
    for t in tensors:
        dist.broadcast(t.data, src=src)


def broadcast_module(module: torch.nn.Module, src: int = 0) -> None:
    """Rank ``src``'s parameters and buffers on every rank."""
    with torch.no_grad():
        broadcast_tensors(list(module.parameters()) + list(module.buffers()), src)


def broadcast_optimizer(optimizer: torch.optim.Optimizer, src: int = 0) -> None:
    """Rank ``src``'s optimizer state on every rank; the state's layout
    (which parameters have one) must already agree."""
    tensors = [v for p in (q for g in optimizer.param_groups for q in g["params"])
               for _, v in sorted(optimizer.state.get(p, {}).items())
               if torch.is_tensor(v)]
    broadcast_tensors(tensors, src)


def same_on_all(values: Sequence[float], device) -> list:
    """Rank 0's ``values`` (floats) on every rank: the decisions taken from
    them (early stopping, the best epoch) are then the same everywhere."""
    t = torch.tensor([float(v) for v in values], dtype=torch.float64, device=device)
    dist.broadcast(t, src=0)
    return t.tolist()


# ---- starting ranks on this machine ----------------------------------------------


def spawn(fn: Callable, world: int, store: str, args: tuple = (), device=None) -> None:
    """Run ``fn(rank, world, rank_device, *args)`` in ``world`` processes
    (start method ``spawn``) joined in one process group through the file
    ``store`` (a path that does not exist yet); ranks get a card each where
    there are enough (nccl), else share ``cuda:0`` (gloo); ``device="cpu"``
    runs them on the CPU (gloo). A rank that raises makes this raise, after
    every rank has ended."""
    import torch.multiprocessing as mp

    dev = torch.device("cuda" if device is None else device)
    mp.start_processes(_rank_main, args=(fn, world, store, str(dev), args), nprocs=world,
                       start_method="spawn", join=True)


def _rank_main(rank: int, fn: Callable, world: int, store: str, device: str,
               args: tuple) -> None:
    import datetime

    dev = rank_device(device, rank, world)
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")  # the ranks share this machine
    dist.init_process_group(backend_for(dev, world), init_method=f"file://{store}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))
    try:
        fn(rank, world, dev, *args)
    finally:
        dist.destroy_process_group()
