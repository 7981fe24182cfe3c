"""Data parallelism over a ``torch.distributed`` device mesh (port of
``dl_biomass_tpu/parallel/mesh.py``).

The JAX package runs SPMD over a ``(dp, mp)`` mesh: the batch axis is sharded
over ``dp`` (``P("dp")``), everything else is replicated, so ``mp`` only
replicates; XLA inserts the sums that make the sharded step compute what the
whole batch gives on one device. Here each mesh coordinate is a process (a
rank) and the sums are written out:

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
    dropout are those of one process on the whole batch.

The layers learn of the mesh from ``data_parallel(mesh)``, a context that
``Trainer`` and the serving engines enter around their forwards and
backwards; without it every path is the one-process path, unchanged. The
mesh needs only ``all_reduce`` and ``broadcast``, which gloo also takes on
CUDA tensors: ``backend_for`` takes nccl where each rank has a card of its
own and gloo where ranks share a card or run on the CPU.

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
    return DeviceMesh(resolve_device(device).type, torch.arange(dp * mp).view(dp, mp),
                      mesh_dim_names=AXES)


# ---- the mesh in use --------------------------------------------------------


@contextlib.contextmanager
def data_parallel(mesh):
    """Run the enclosed forwards and backwards over ``mesh`` (None: one
    process). A plain global, not a context variable: autograd runs a CUDA
    backward on a thread of its own."""
    global _active
    prev, _active = _active, mesh
    try:
        yield mesh
    finally:
        _active = prev


def active():
    """The mesh of the enclosing ``data_parallel``, or None."""
    return _active


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


def sum_dp(t: torch.Tensor, mesh, *, grad: bool = False) -> torch.Tensor:
    """The sum of ``t`` over the ``dp`` group of ``mesh`` (``t`` itself
    without one), a new tensor; ``grad=True`` keeps it differentiable."""
    if mesh is None:
        return t
    group = mesh.get_group("dp")
    if grad:
        return _SumDP.apply(t, group)
    t = t.detach().clone(memory_format=torch.contiguous_format)
    dist.all_reduce(t, group=group)
    return t


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


def sum_grads(params, mesh) -> None:
    """Sum every parameter's ``.grad`` over the ``dp`` group, in place, in one
    flat buffer (a missing gradient counts as 0)."""
    params = [p for p in params if p.requires_grad]
    grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=mesh.get_group("dp"))
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
