"""Data-parallel training and evaluation over the cards of one or more
hosts.

Port of ``brainmagick_tpu/parallel/__init__.py`` in PyTorch's idiom: one
process a card, started by ``python -m torch.distributed.run
--nproc_per_node=N`` on each host (``--nnodes=H``), NCCL between the
cards and gloo on the CPU. Where the JAX package's mesh puts contiguous
row blocks of one global batch on its devices, rank r keeps block r
(``process_rows``):

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

Hosts. A JAX process is a host that holds several chips; here a process
is a card. ``DataGroup`` learns each rank's host from the launcher's
environment (``GROUP_RANK``, the node rank; ``LOCAL_WORLD_SIZE``), gathered
over the group so that every rank agrees (``HostLayout``). The launcher
numbers ranks node by node, so a host's ranks hold adjacent row blocks,
and ``DataGroup.host_rows`` is the block the JAX package's
``process_rows`` gives process h; any other layout, and unequal ranks per
host, raise. The train step is global (its loss, gradients and pools span
every rank, as the JAX step spans every process), while evaluation runs
per host as the JAX package's does per process: ``forward_batch`` gathers
within the host (``DataGroup.host``), each host scores its rows against
its own pool, and ``average_metrics_across_processes`` averages the scalar
metrics over the hosts. ``lead_first`` orders the dataset build by host:
each host's first rank fills that host's caches before its other ranks
read them.

``make_mesh``, ``shard_array`` and ``shard_batch`` have no counterpart: a
process holds one card. A gloo group carries a CUDA tensor through a host
copy (gloo's own CUDA support stops at all-reduce and broadcast); that is
how ranks that share one card meet in ``chip_smoke.py``. Each
collective is a span (``tracing.span``): under ``torch.profiler`` the
range ``bm.<name>`` (``bm.all_reduce``, ``bm.all_gather``,
``bm.broadcast``, ``bm.exchange``, ``bm.reduce_scatter``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import os
import typing as tp

import torch
import torch.distributed as dist

from . import tracing

#: how long a rank waits for the others in a collective: each host's
#: first rank builds the datasets (preprocessing included) while the
#: host's other ranks wait (``lead_first``)
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
    (made the current card) for a CUDA `device` without an index, the
    card `device` names when it has one, else the CPU. The
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
        if device.index is None:
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


@tracing.span("all_reduce")
def all_reduce(tensor: torch.Tensor, group: tp.Any) -> torch.Tensor:
    """Sum `tensor` over `group`'s ranks, in place; returns it."""
    backend = _backend(group)
    if _staged(tensor, backend):
        host = tensor.cpu()
        dist.all_reduce(host, group=group)
        return tensor.copy_(host)
    dist.all_reduce(tensor, group=group)
    return tensor


@tracing.span("all_gather")
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


@tracing.span("broadcast")
def broadcast(tensor: torch.Tensor, src: int, group: tp.Any) -> torch.Tensor:
    """Global rank `src`'s `tensor` on every rank of `group`, in place."""
    backend = _backend(group)
    if _staged(tensor, backend):
        host = tensor.cpu()
        dist.broadcast(host, src, group=group)
        return tensor.copy_(host)
    dist.broadcast(tensor, src, group=group)
    return tensor


@tracing.span("exchange")
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
            with tracing.span("reduce_scatter"):
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


@dataclasses.dataclass(frozen=True)
class HostLayout:
    """The hosts of a run: each host's ranks, as positions in the run's
    group, hosts in the order of their first rank."""
    hosts: tp.Tuple[tp.Tuple[int, ...], ...]

    @classmethod
    def from_ranks(cls, nodes: tp.Sequence[tp.Tuple[int, int]]
                   ) -> "HostLayout":
        """The layout of ranks whose (node id, local world size) are
        `nodes`, in rank order; a local world size below 0 is not known.
        Raises ValueError unless every host's ranks are adjacent (the
        launcher numbers ranks node by node), every host has as many
        ranks, and each known local world size is its host's count."""
        by_node: tp.Dict[int, tp.List[int]] = {}
        for rank, (node, _) in enumerate(nodes):
            by_node.setdefault(node, []).append(rank)
        hosts = tuple(tuple(ranks) for ranks in by_node.values())
        for node, ranks in by_node.items():
            if ranks != list(range(ranks[0], ranks[0] + len(ranks))):
                raise ValueError(
                    f"the ranks of node {node} are {ranks}: a host's ranks "
                    f"must be adjacent (node by node, as the launcher "
                    f"numbers them), so that its rows are one block")
        if len({len(ranks) for ranks in hosts}) > 1:
            raise ValueError(
                f"unequal ranks per host ({[len(r) for r in hosts]}): the "
                f"batch splits into one equal block a host")
        for rank, (node, local_world) in enumerate(nodes):
            if local_world >= 0 and local_world != len(by_node[node]):
                raise ValueError(
                    f"rank {rank}: LOCAL_WORLD_SIZE={local_world}, but node "
                    f"{node} has {len(by_node[node])} ranks in the group")
        return cls(hosts)

    @property
    def size(self) -> int:
        return len(self.hosts)

    def host_of(self, rank: int) -> int:
        return next(h for h, ranks in enumerate(self.hosts) if rank in ranks)

    def host_rows(self, n_global: int, host: int) -> slice:
        """Host `host`'s contiguous block of a global batch of `n_global`
        rows: the JAX package's ``process_rows`` of process `host`, the
        union of its ranks' ``process_rows``."""
        return process_rows(n_global, host, self.size)


class DataGroup:
    """The ranks of one data-parallel run (`group`, the whole launch when
    None), every one in it the same code path: rank r's rows, the pools of
    candidates, the collectives on the run's group, and the hosts the
    ranks sit on (``HostLayout``, gathered from the launcher's
    environment): ``n_hosts``, ``host_index``, ``host`` (the DataGroup of
    this host's ranks, the run's own on one host) and ``host_rows``."""

    def __init__(self, group: tp.Any = None,
                 layout: tp.Optional[HostLayout] = None) -> None:
        self.group = dist.group.WORLD if group is None else group
        self.size = dist.get_world_size(self.group)
        self.rank = dist.get_rank(self.group)
        self.ranks = tuple(dist.get_process_group_ranks(self.group))
        self.backend = _backend(self.group)
        self._pools: tp.Dict[int, Pool] = {}
        if layout is None:
            layout = HostLayout.from_ranks(self._gather_nodes())
        self.layout = layout
        self.n_hosts = layout.size
        self.host_index = layout.host_of(self.rank)
        self.host = self if self.n_hosts == 1 else self._host_group()

    @property
    def collective_device(self) -> torch.device:
        """Where this group's collectives take a new tensor: the current
        card under NCCL, else the CPU."""
        if self.backend == "nccl":
            return torch.device("cuda", torch.cuda.current_device())
        return torch.device("cpu")

    def _gather_nodes(self) -> tp.List[tp.Tuple[int, int]]:
        """Every rank's (node rank, local world size) from the launcher's
        environment (``GROUP_RANK``, ``LOCAL_WORLD_SIZE``), in rank order:
        node 0 where the launcher set none (one host), and the local world
        size only for the launch's whole group, which it counts (-1, not
        known, otherwise)."""
        node = int(os.environ.get("GROUP_RANK", 0))
        local_world = int(os.environ.get("LOCAL_WORLD_SIZE", -1)) \
            if self.group is dist.group.WORLD else -1
        mine = torch.tensor([[node, local_world]], dtype=torch.int64,
                            device=self.collective_device)
        if self.size > 1:
            mine = self.all_gather(mine)
        return [tuple(row) for row in mine.tolist()]

    def _host_group(self) -> "DataGroup":
        """This host's ranks as a DataGroup. Every rank creates every
        host's process group, in the same order."""
        mine = None
        for h, block in enumerate(self.layout.hosts):
            group = dist.new_group([self.ranks[i] for i in block])
            if h == self.host_index:
                mine = DataGroup(group, HostLayout(
                    (tuple(range(len(block))),)))
        return mine

    @property
    def lead(self) -> bool:
        """Whether this rank writes the run's files (rank 0)."""
        return self.rank == 0

    def rows(self, n_global: int) -> slice:
        return process_rows(n_global, self.rank, self.size)

    def host_rows(self, n_global: int) -> slice:
        """This host's contiguous block of a global batch of `n_global`
        rows (``HostLayout.host_rows``), the union of its ranks'
        ``rows``."""
        return self.layout.host_rows(n_global, self.host_index)

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


def average_metrics_across_processes(metrics: tp.Dict[str, float],
                                     group: tp.Optional[DataGroup]
                                     ) -> tp.Dict[str, float]:
    """The mean over the hosts of `group` of each scalar metric, in
    float64, the keys sorted (the JAX package's function of the same name,
    whose processes are hosts): every host holds its own rows' metrics,
    and every rank gets the mean. Without a group or on one host,
    `metrics` itself."""
    if group is None or group.n_hosts == 1:
        return metrics
    keys = sorted(metrics)
    values = torch.tensor([[float(metrics[k]) for k in keys]],
                          dtype=torch.float64,
                          device=group.collective_device)
    every = group.all_gather(values).cpu().numpy()
    leads = [ranks[0] for ranks in group.layout.hosts]
    return dict(zip(keys, every[leads].mean(axis=0).tolist()))


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
    """Run the block on each host's first rank before that host's other
    ranks run it: the first rank fills the host's caches, which the others
    then read. The hosts run it at the same time, each in its own
    caches."""
    host = None if group is None else group.host
    if host is None or host.size == 1:
        yield
        return
    if not host.lead:
        host.barrier()
    yield
    if host.lead:
        host.barrier()
