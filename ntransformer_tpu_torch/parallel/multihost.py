"""Multi-process bring-up and the (dp, tp) mesh.

Port of ntransformer_tpu/parallel/multihost.py. A mesh is a [dp][tp] grid
of torch devices, TP innermost, in which a device may repeat (two groups of
two shards on one card run every product at its shard shape; on a host with
four cards, one position on each). One process drives every position it
owns, as in parallel/tp.py; a mesh that spans processes records the owning
process rank of each position, and each process computes only its own.

Typical multi-process launch (the same command in every process, each
passing its own rank and the cards it owns):

    from ntransformer_tpu_torch.parallel.multihost import initialize, make_mesh
    initialize("10.0.0.1:29500", num_processes=2, process_id=rank,
               backend="nccl")
    torch.cuda.set_device(rank)
    mesh = make_mesh(tp=1, devices=[f"cuda:{rank}"])   # dp across processes

The backend is the caller's choice: "nccl" when each process owns its cards,
"gloo" on the CPU or when processes share a card (NCCL refuses two ranks on
one card). With gloo, CUDA tensors are staged through host memory
explicitly. A failed start or collective raises.

Collectives. Where the shards of one tp row live in several processes, the
row's partial sums and embedding slices are all-gathered over the row's own
process group (one broadcast per shard from its owner) and summed in shard
order in every process, so the bits equal the one-process sums. The
batched step's logits are gathered across dp groups over the whole world,
each group's from the lowest rank that computes it.
"""
from __future__ import annotations

import contextlib
import dataclasses
import weakref

import torch

from ..models.loader import resolve_device
from ..utils import logging as log

DP_AXIS = "dp"
TP_AXIS = "tp"  # must match parallel.tp's plan


def initialize(coordinator_address: str, num_processes: int, process_id: int,
               *, backend: str) -> None:
    """Start torch.distributed at tcp://coordinator_address (host:port) as
    process `process_id` of `num_processes` over `backend` ("nccl" or
    "gloo", chosen by the caller and logged). A no-op when the process
    group is already up; a failed start raises."""
    import torch.distributed as dist
    if dist.is_initialized():
        return
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend {backend!r}: want 'nccl' (each process "
                         "owns its cards) or 'gloo' (the CPU, or processes "
                         "sharing a card)")
    log.info(f"torch.distributed: process {process_id} of {num_processes} "
             f"at tcp://{coordinator_address}, backend {backend}")
    dist.init_process_group(backend,
                            init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)


# the objects whose captured programs hold collectives over a process
# group (models/graphs.py StepGraphs and ForwardGraphs over a row across
# processes): NCCL keeps a communicator's captured work alive while its
# CUDA graph lives, and destroying the group waits for that work, so two
# processes that shut down with such graphs alive wait for ever
_HOLDERS: weakref.WeakSet = weakref.WeakSet()


def release_at_shutdown(holder) -> None:
    """Have shutdown() call holder.release(), which drops its captured
    programs, before it destroys the process group."""
    _HOLDERS.add(holder)


def shutdown() -> None:
    """Leave the process group (a no-op when none is up): every process
    calls it before it exits, so no collective thread outlives the
    interpreter. The captured programs that hold the group's collectives
    are dropped first (release_at_shutdown): their objects then capture
    again at their next call, which needs a process group."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
        for holder in list(_HOLDERS):
            holder.release()
        _HOLDERS.clear()
        dist.destroy_process_group()


def _process_devices(local: list[torch.device]
                     ) -> tuple[int, list[list[torch.device]]]:
    """(this process's rank, every process's local devices in rank
    order)."""
    import torch.distributed as dist
    if not (dist.is_available() and dist.is_initialized()) \
            or dist.get_world_size() == 1:
        return 0, [local]
    rank, world = dist.get_rank(), dist.get_world_size()
    names = [None] * world
    dist.all_gather_object(names, [str(d) for d in local])
    return rank, [[torch.device(d) for d in ds] for ds in names]


class Row(tuple):
    """One tp row of a mesh: its devices in shard order (a tuple, as
    parallel/tp.py takes it), the rank owning each shard, this process's
    rank, and, where the row spans processes, the process group of its
    collectives."""

    def __new__(cls, devices, ranks=None, rank: int = 0, group=None):
        row = super().__new__(cls, (torch.device(d) for d in devices))
        row.ranks = tuple(ranks) if ranks is not None else (rank,) * len(row)
        row.rank = rank
        row.group = group
        return row

    @property
    def owned(self) -> list[int]:
        """The shard indices this process computes."""
        return [s for s, r in enumerate(self.ranks) if r == self.rank]

    @property
    def home(self) -> torch.device:
        """The device of this process's first shard, where the replicated
        work and the sums run."""
        return self[self.owned[0]]


def owned(row) -> list[int]:
    """The shard indices of `row` this process computes: all of them for a
    plain tuple of devices."""
    return row.owned if isinstance(row, Row) else list(range(len(row)))


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """A [dp][tp] grid of torch devices, TP innermost, with the owning
    process rank of each position (make_mesh builds it)."""

    devices: tuple
    ranks: tuple
    rank: int = 0
    groups: tuple = ()   # per dp row: its process group, or None

    @property
    def dp(self) -> int:
        return len(self.devices)

    @property
    def tp(self) -> int:
        return len(self.devices[0])

    @property
    def axis_names(self) -> tuple[str, ...]:
        return (TP_AXIS,) if self.dp == 1 else (DP_AXIS, TP_AXIS)

    @property
    def shape(self) -> dict[str, int]:
        sizes = {DP_AXIS: self.dp, TP_AXIS: self.tp}
        return {a: sizes[a] for a in self.axis_names}

    @property
    def multiprocess(self) -> bool:
        return len({r for rs in self.ranks for r in rs}) > 1

    def row(self, g: int) -> Row:
        return Row(self.devices[g], self.ranks[g], self.rank,
                   self.groups[g] if self.groups else None)

    def touches(self, g: int) -> bool:
        """Whether this process computes a shard of dp row g."""
        return self.rank in self.ranks[g]

    @property
    def home(self) -> torch.device:
        """The first device this process owns."""
        g = next(g for g in range(self.dp) if self.touches(g))
        return self.row(g).home


def make_mesh(tp: int | None = None, dp: int | None = None,
              devices=None) -> Mesh:
    """(dp, tp) mesh, TP innermost. `devices`: this process's devices, in
    which one may repeat (["cpu"] * n, ["cuda:0"] * n); by default its CUDA
    cards (raises without CUDA). A process group of several processes
    joins every process's devices in rank order. With only one axis given
    the other is inferred to cover all devices (tp defaults to this
    process's device count); with both given the mesh may use a leading
    subset (dp * tp <= n), except across processes. dp == 1 gives a
    tp-only mesh."""
    if devices is None:
        resolve_device("cuda")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    local = [torch.device(d) for d in devices]
    rank, everyone = _process_devices(local)
    flat = [d for ds in everyone for d in ds]
    owners = [r for r, ds in enumerate(everyone) for _ in ds]
    n, world = len(flat), len(everyone)
    explicit = tp is not None and dp is not None
    if tp is None:
        tp = min(n, max(1, len(local)))
    if dp is None:
        dp = n // tp
    if tp < 1 or dp < 1:
        raise ValueError(f"dp({dp}) and tp({tp}) must be at least 1")
    if explicit:
        if dp * tp > n:
            raise ValueError(f"dp({dp}) * tp({tp}) > n_devices({n})")
        if dp * tp < n and world > 1:
            # a leading subset can leave out every device of a process,
            # which would then drive a mesh it is not in
            raise ValueError(
                f"dp({dp}) * tp({tp}) covers only {dp * tp} of {n} devices "
                f"across {world} processes; multi-process meshes must use "
                "all devices (pick dp*tp == n)")
    elif dp * tp != n:
        raise ValueError(f"dp({dp}) * tp({tp}) != n_devices({n})")
    grid = tuple(tuple(flat[g * tp:(g + 1) * tp]) for g in range(dp))
    ranks = tuple(tuple(owners[g * tp:(g + 1) * tp]) for g in range(dp))
    groups = ()
    if world > 1:
        # every process creates every group, in the same order
        import torch.distributed as dist
        made = {}
        for rs in ranks:
            key = tuple(sorted(set(rs)))
            if len(key) > 1 and key not in made:
                made[key] = dist.new_group(list(key))
        groups = tuple(made.get(tuple(sorted(set(rs)))) for rs in ranks)
    return Mesh(grid, ranks, rank, groups)


def backend_of(group=None) -> str | None:
    """The backend of a process group ("nccl" or "gloo"; None: the
    default group), or None where no process group is up."""
    import torch.distributed as dist
    if not (dist.is_available() and dist.is_initialized()):
        return None
    return str(dist.get_backend(group))


def _staged(t: torch.Tensor, group) -> bool:
    """Whether a collective on t goes through host memory: gloo on a CUDA
    tensor."""
    return t.is_cuda and backend_of(group) == "gloo"


def broadcast(t: torch.Tensor, src: int, group=None) -> torch.Tensor:
    """t from process `src` (a global rank) to every process of `group`;
    returns the received tensor on t's device (t itself at src). Gloo
    stages a CUDA tensor through host memory."""
    import torch.distributed as dist
    if _staged(t, group):
        host = t.to("cpu").contiguous()
        dist.broadcast(host, src, group=group)
        return t if dist.get_rank() == src else host.to(t.device)
    buf = t.contiguous()
    with (torch.cuda.device(buf.device) if buf.is_cuda
          else contextlib.nullcontext()):
        dist.broadcast(buf, src, group=group)
    return buf


def gather_shards(xs: list, row) -> list:
    """Every shard's tensor of `row`: xs holds this process's shards'
    tensors and None where another process owns the shard; each missing
    one comes from its owner (one broadcast a shard over the row's group,
    in shard order). The shards' tensors share a shape and dtype. xs
    itself for a row in one process."""
    if not isinstance(row, Row) or row.group is None:
        return xs
    ref = next(x for x in xs if x is not None)
    out = []
    for s, x in enumerate(xs):
        src = row.ranks[s]
        buf = x if src == row.rank else torch.empty_like(ref)
        out.append(broadcast(buf, src, row.group))
    return out


def gather_groups(parts: list, mesh: Mesh, device) -> torch.Tensor:
    """The dp groups' outputs concatenated in slot order on `device`.
    parts[g] is group g's tensor where this process computes it, else
    None; across processes each group's comes from the lowest rank that
    computes it (one broadcast a group over the whole world)."""
    if mesh.multiprocess:
        ref = next(p for p in parts if p is not None)
        parts = [broadcast(p if p is not None else torch.empty_like(ref),
                           min(mesh.ranks[g]))
                 for g, p in enumerate(parts)]
    return torch.cat([p.to(device) for p in parts])
