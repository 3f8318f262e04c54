"""Data-parallel training and evaluation over the cards of one host.

Port of ``brainmagick_tpu/parallel/__init__.py`` in PyTorch's idiom: one
process a card, started by ``python -m torch.distributed.run
--nproc_per_node=N``, NCCL between the cards and gloo on the CPU. Where
the JAX package's single-process mesh puts contiguous row blocks of one
global batch on its devices, rank r keeps block r (``process_rows``):

- ``init_distributed`` joins the launcher's ranks, each on its own card;
- ``replicate`` gives every rank rank 0's weights and buffers;
- ``DataGroup`` holds the ranks of a run, the contiguous groups of
  ``parallel.negatives_group_size`` ranks whose rows make one CLIP
  candidate pool (``DataGroup.pool``), and the collectives that the
  solver and the evaluation call: ``all_reduce``, ``all_gather``,
  ``gather_rows`` (autograd-aware: its backward sums each row's
  cotangents on the rank that owns the row, as the transpose of JAX's
  ``all_gather`` does) and ``ring_hop`` (a P2P pass to the left
  neighbour, whose backward passes the cotangents right, as the
  transpose of ``ppermute`` does).

``make_mesh``, ``shard_array`` and ``shard_batch`` have no counterpart: a
process holds one card. A gloo group carries a CUDA tensor through a host
copy (gloo's own CUDA support stops at all-reduce and broadcast); that is
how two ranks that share one card meet in ``chip_smoke.py``. Each
collective is a ``parallel.<name>`` range in ``torch.profiler``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import os
import typing as tp

import torch
import torch.distributed as dist
from torch.profiler import record_function

#: how long a rank waits for the others in a collective: rank 0 builds
#: the datasets (preprocessing included) while the others wait
#: (``lead_first``)
DEFAULT_TIMEOUT = datetime.timedelta(minutes=30)


def launched() -> bool:
    """Whether a launcher (``torch.distributed.run``) started this
    process: its environment names the world size."""
    return "WORLD_SIZE" in os.environ


def init_distributed(device: tp.Union[str, torch.device],
                     backend: tp.Optional[str] = None,
                     timeout: datetime.timedelta = DEFAULT_TIMEOUT
                     ) -> torch.device:
    """Join the launcher's process group as rank ``RANK`` of
    ``WORLD_SIZE`` and return this rank's device: ``cuda:LOCAL_RANK``
    (made the current card) for a CUDA `device`, else the CPU. The
    backend is NCCL for a CUDA device and gloo for the CPU unless
    `backend` says otherwise. A group the caller initialized already
    (with its own store) is kept when it has this rank and world size. A
    failed initialization raises."""
    device = torch.device(device)
    try:
        rank = int(os.environ["RANK"])
        world = int(os.environ["WORLD_SIZE"])
    except KeyError as exc:
        raise RuntimeError(f"no launcher's environment ({exc.args[0]} is "
                           f"not set): start the ranks with python -m "
                           f"torch.distributed.run") from None
    local = int(os.environ.get("LOCAL_RANK", rank))
    if device.type == "cuda":
        device = torch.device("cuda", local)
        torch.cuda.set_device(device)
    elif device.type != "cpu":
        raise ValueError(f"device {device}: 'cuda' or 'cpu'")
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if dist.is_initialized():
        if (dist.get_rank(), dist.get_world_size()) != (rank, world):
            raise RuntimeError(
                f"the process group has rank {dist.get_rank()} of "
                f"{dist.get_world_size()}, the launcher {rank} of {world}")
        return device
    dist.init_process_group(
        backend, init_method="env://", rank=rank, world_size=world,
        timeout=timeout,
        device_id=device if backend == "nccl" else None)
    return device


def process_rows(n_global: int, rank: int, world: int) -> slice:
    """Rank `rank`'s contiguous block of a global batch of `n_global`
    rows that every rank draws alike (the JAX package's per-process
    rows; the reference's DistributedSampler partitions one seeded index
    order the same way)."""
    if n_global % world:
        raise ValueError(f"global batch {n_global} must divide over "
                         f"{world} ranks")
    local = n_global // world
    return slice(rank * local, (rank + 1) * local)


def slice_global_batch(arrays: tp.Mapping[str, tp.Any], pad_weight: tp.Any,
                       rank: int, world: int
                       ) -> tp.Tuple[tp.Dict[str, tp.Any], tp.Any]:
    """A global batch's arrays and pad weights reduced to rank `rank`'s
    rows (all of them for one rank)."""
    if world == 1:
        return dict(arrays), pad_weight
    rows = process_rows(len(pad_weight), rank, world)
    return {k: v[rows] for k, v in arrays.items()}, pad_weight[rows]


#: rank r's seed offset is r times this (the 32-bit golden ratio)
_SEED_STRIDE = 0x9E3779B1


def rank_seed(seed: int, rank: int) -> int:
    """The seed of rank `rank`'s generator for a run seeded `seed`: `seed`
    itself on rank 0, so that one rank draws what a run without ranks
    draws, and on every other rank `seed` plus rank times a stride far
    from any (seed, epoch, stage) the run uses, modulo 2^32 (the CPU
    generator keeps 32 bits of a seed). The JAX step splits its key over
    the devices."""
    return seed if rank == 0 else (seed + rank * _SEED_STRIDE) % 2 ** 32


def _backend(group: tp.Any) -> str:
    return str(dist.get_backend(group))


def _staged(tensor: torch.Tensor, backend: str) -> bool:
    """Whether a collective carries `tensor` through a host copy."""
    return backend == "gloo" and tensor.is_cuda


def _wire(tensor: torch.Tensor) -> torch.Tensor:
    """A contiguous tensor a backend takes (bool as uint8)."""
    tensor = tensor.contiguous()
    return tensor.view(torch.uint8) if tensor.dtype == torch.bool else tensor


@record_function("parallel.all_reduce")
def all_reduce(tensor: torch.Tensor, group: tp.Any) -> torch.Tensor:
    """Sum `tensor` over `group`'s ranks, in place; returns it."""
    backend = _backend(group)
    if _staged(tensor, backend):
        host = tensor.cpu()
        dist.all_reduce(host, group=group)
        return tensor.copy_(host)
    dist.all_reduce(tensor, group=group)
    return tensor


@record_function("parallel.all_gather")
def all_gather(tensor: torch.Tensor, group: tp.Any) -> torch.Tensor:
    """Every rank's `tensor` (the same shape on each) concatenated along
    the first dimension in rank order, on every rank."""
    backend = _backend(group)
    size = dist.get_world_size(group)
    wire = _wire(tensor)
    if _staged(wire, backend):
        wire = wire.cpu()
    if backend == "nccl":
        out = wire.new_empty((size * wire.shape[0],) + wire.shape[1:])
        dist.all_gather_into_tensor(out, wire, group=group)
    else:
        parts = [torch.empty_like(wire) for _ in range(size)]
        dist.all_gather(parts, wire, group=group)
        out = torch.cat(parts)
    out = out.to(tensor.device)
    return out.view(torch.bool) if tensor.dtype == torch.bool else out


@record_function("parallel.broadcast")
def broadcast(tensor: torch.Tensor, src: int, group: tp.Any) -> torch.Tensor:
    """Global rank `src`'s `tensor` on every rank of `group`, in place."""
    backend = _backend(group)
    if _staged(tensor, backend):
        host = tensor.cpu()
        dist.broadcast(host, src, group=group)
        return tensor.copy_(host)
    dist.broadcast(tensor, src, group=group)
    return tensor


@record_function("parallel.exchange")
def exchange(tensors: tp.Sequence[torch.Tensor], send_to: int,
             recv_from: int, backend: str) -> tp.List[torch.Tensor]:
    """Send `tensors` to global rank `send_to` and receive as many of the
    same shapes and types from `recv_from`, in one batch of P2P
    operations."""
    device = tensors[0].device
    staged = _staged(tensors[0], backend)
    send = [t.contiguous().cpu() if staged else t.contiguous()
            for t in tensors]
    recv = [torch.empty_like(t) for t in send]
    ops = [dist.P2POp(dist.isend, t, send_to) for t in send] \
        + [dist.P2POp(dist.irecv, t, recv_from) for t in recv]
    for request in dist.batch_isend_irecv(ops):
        request.wait()
    return [t.to(device) for t in recv] if staged else recv


@dataclasses.dataclass(frozen=True)
class Pool:
    """A contiguous group of ranks whose rows make one CLIP candidate
    pool: its global ranks in order, this rank's position among them, its
    process group, and this rank's neighbours on the group's ring."""
    ranks: tp.Tuple[int, ...]
    position: int
    group: tp.Any
    backend: str

    @property
    def size(self) -> int:
        return len(self.ranks)

    @property
    def left(self) -> int:
        return self.ranks[(self.position - 1) % self.size]

    @property
    def right(self) -> int:
        return self.ranks[(self.position + 1) % self.size]


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, rows: torch.Tensor, pool: Pool) -> torch.Tensor:
        ctx.pool = pool
        return all_gather(rows, pool.group)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        pool = ctx.pool
        grad = grad.contiguous()
        b = grad.shape[0] // pool.size
        if pool.backend == "nccl":
            out = grad.new_empty((b,) + grad.shape[1:])
            with record_function("parallel.reduce_scatter"):
                dist.reduce_scatter_tensor(out, grad, group=pool.group)
            return out, None
        total = all_reduce(grad.clone(), pool.group)
        return total[pool.position * b:(pool.position + 1) * b], None


def gather_rows(rows: torch.Tensor, pool: Pool) -> torch.Tensor:
    """The rows of every rank of `pool` [k * b, ...] in rank order, on each
    of them; the gradient of a gathered row sums back on its rank."""
    return _GatherRows.apply(rows, pool)


class _RingHop(torch.autograd.Function):
    @staticmethod
    def forward(ctx, block: torch.Tensor, weight: torch.Tensor, pool: Pool):
        ctx.pool = pool
        block, weight = exchange([block, weight], pool.left, pool.right,
                                 pool.backend)
        ctx.mark_non_differentiable(weight)
        return block, weight

    @staticmethod
    def backward(ctx, grad: torch.Tensor, _):
        pool = ctx.pool
        (grad,) = exchange([grad], pool.right, pool.left, pool.backend)
        return grad, None, None


def ring_hop(block: torch.Tensor, weight: torch.Tensor, pool: Pool
             ) -> tp.Tuple[torch.Tensor, torch.Tensor]:
    """One hop around `pool`'s ring: this rank's (block, weight) to its
    left neighbour, the right neighbour's in return; the block's gradient
    travels back the other way."""
    return _RingHop.apply(block, weight, pool)


class DataGroup:
    """The ranks of one data-parallel run (`group`, the whole launch when
    None), every one in it the same code path: rank r's rows, the pools of
    candidates, and the collectives on the run's group."""

    def __init__(self, group: tp.Any = None) -> None:
        self.group = dist.group.WORLD if group is None else group
        self.size = dist.get_world_size(self.group)
        self.rank = dist.get_rank(self.group)
        self.ranks = tuple(dist.get_process_group_ranks(self.group))
        self.backend = _backend(self.group)
        self._pools: tp.Dict[int, Pool] = {}

    @property
    def lead(self) -> bool:
        """Whether this rank writes the run's files (rank 0)."""
        return self.rank == 0

    def rows(self, n_global: int) -> slice:
        return process_rows(n_global, self.rank, self.size)

    def pool(self, k: int) -> Pool:
        """This rank's contiguous group of `k` ranks (k divides the run's
        size). Every rank creates every group, in the same order, the
        first time a k is asked for."""
        if k not in self._pools:
            if k < 1 or self.size % k:
                raise ValueError(f"a pool of {k} ranks in a run of "
                                 f"{self.size}")
            mine = None
            for start in range(0, self.size, k):
                ranks = self.ranks[start:start + k]
                group = self.group if k == self.size else dist.new_group(
                    list(ranks))
                if self.rank // k == start // k:
                    mine = Pool(ranks, self.rank % k, group, self.backend)
            self._pools[k] = mine
        return self._pools[k]

    def all_reduce(self, tensor: torch.Tensor) -> torch.Tensor:
        return all_reduce(tensor, self.group)

    def all_gather(self, tensor: torch.Tensor) -> torch.Tensor:
        return all_gather(tensor, self.group)

    def broadcast_object(self, value: tp.Any) -> tp.Any:
        """Rank 0's `value` on every rank."""
        box = [value]
        dist.broadcast_object_list(box, src=self.ranks[0], group=self.group)
        return box[0]

    def barrier(self) -> None:
        if self.backend == "nccl":
            dist.barrier(self.group,
                         device_ids=[torch.cuda.current_device()])
        else:
            dist.barrier(self.group)

    def gather_split(self, rows: torch.Tensor, n: int) -> torch.Tensor:
        """Every rank's block of an `n`-row result split by ``split(n)``,
        [n, ...] in rank order, on every rank."""
        per = -(-n // self.size)
        pad = per - rows.shape[0]
        if pad:
            rows = torch.cat([rows, rows.new_zeros((pad,) + rows.shape[1:])])
        return self.all_gather(rows)[:n]

    def split(self, n: int) -> slice:
        """This rank's block of `n` rows in blocks of ceil(n / size) (the
        last ranks' shorter or empty)."""
        per = -(-n // self.size)
        return slice(min(n, self.rank * per), min(n, (self.rank + 1) * per))


@torch.no_grad()
def replicate(modules: tp.Iterable[tp.Optional[torch.nn.Module]],
              group: DataGroup) -> None:
    """Rank 0's parameters and buffers in `modules` on every rank."""
    for module in modules:
        if module is None:
            continue
        for tensor in list(module.parameters()) + list(module.buffers()):
            broadcast(tensor.data, group.ranks[0], group.group)


@contextlib.contextmanager
def lead_first(group: tp.Optional[DataGroup]) -> tp.Iterator[None]:
    """Run the block on rank 0 before the other ranks run it (rank 0 fills
    the caches the others then read)."""
    if group is None or group.size == 1:
        yield
        return
    if not group.lead:
        group.barrier()
    yield
    if group.lead:
        group.barrier()
