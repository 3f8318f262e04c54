"""Batches of a dataset, assembled by host threads ahead of the consumer.

Port of ``brainmagick_tpu/loader.py``: the same index order
(``RandomState(seed + epoch)`` shuffles), ``drop_last``, and a trailing
partial batch filled with copies of its last row, weighted 0 in
``pad_weight``, so that every batch has the same shape.

Without a device the loader yields host batches of numpy arrays, as the
JAX package's does. With one it yields the batch's ``ARRAY_FIELDS`` and
``pad_weight`` as tensors on that device, meg and features in
`assemble_dtype` (``parallel.assemble_dtype``): for a CUDA device each
batch is copied into one of two page-locked buffer sets and sent with
non-blocking copies, and a set is written again only after the CUDA event
recorded behind its copies has completed.

With ``rows`` (a slice), each batch holds only those rows of the global
batch the loader would build otherwise: the rank's block of a
data-parallel run (``Solver.set_group``), whose ranks all draw the same
seeded index order.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import typing as tp
from concurrent import futures

import numpy as np
import torch

from .dataset import to_device
from .precision import torch_dtype
from .utils import transfer


class _Staging:
    """Two page-locked buffer sets for host -> CUDA copies, each reused
    only after the event recorded behind its last copies."""

    def __init__(self) -> None:
        self._sets: tp.List[tp.Dict[str, torch.Tensor]] = [{}, {}]
        self._events: tp.List[tp.Optional[torch.cuda.Event]] = [None, None]
        self._next = 0

    def send(self, batch: tp.Any, pad_weight: np.ndarray,
             device: torch.device, dtype: tp.Optional[str]
             ) -> tp.Tuple[tp.Dict[str, torch.Tensor], torch.Tensor]:
        k, self._next = self._next, 1 - self._next
        if self._events[k] is not None:
            self._events[k].synchronize()
        buffers = self._sets[k]
        arrays = to_device(batch, device, dtype, buffers)
        weight = transfer(pad_weight, device, buffers=buffers,
                          name="pad_weight")
        event = torch.cuda.Event()
        event.record()
        self._events[k] = event
        return arrays, weight


class Loader:
    def __init__(self, dataset: tp.Any, batch_size: int,
                 shuffle: bool = False, seed: int = 0,
                 drop_last: bool = False, num_workers: int = 4,
                 prefetch: int = 2, with_events: bool = False,
                 assemble_dtype: tp.Optional[str] = None,
                 device: tp.Optional[tp.Union[str, torch.device]] = None
                 ) -> None:
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.num_workers = max(1, num_workers)
        self.prefetch = prefetch
        self.with_events = with_events
        self.device = None if device is None else torch.device(device)
        if assemble_dtype not in (None, "float32") and self.device is None:
            raise ValueError("a host loader assembles fp32 only; give it a "
                             "device for assemble_dtype="
                             f"{assemble_dtype!r}")
        torch_dtype(assemble_dtype)           # refuses an unknown name
        self.assemble_dtype = assemble_dtype
        self.epoch = 0
        #: the rows of each global batch this loader builds (all if None)
        self.rows: tp.Optional[slice] = None

    def set_epoch(self, epoch: int) -> None:
        """The epoch whose shuffle the next iteration draws."""
        self.epoch = epoch

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def _indices(self) -> np.ndarray:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            rng = np.random.RandomState(self.seed + self.epoch)
            rng.shuffle(idx)
        return idx

    def _build(self, indices: np.ndarray, b: int
               ) -> tp.Tuple[tp.Any, np.ndarray]:
        lo = b * self.batch_size
        chunk = indices[lo: lo + self.batch_size]
        pad_weight = np.ones(self.batch_size, dtype=np.float32)
        if len(chunk) < self.batch_size:
            pad = self.batch_size - len(chunk)
            pad_weight[len(chunk):] = 0.
            chunk = np.concatenate([chunk, chunk[-1:].repeat(pad)])
        if self.rows is not None:
            chunk, pad_weight = chunk[self.rows], pad_weight[self.rows]
        return self.dataset.get_batch(chunk, with_events=self.with_events), \
            pad_weight

    def _host_batches(self) -> tp.Iterator[tp.Tuple[tp.Any, np.ndarray]]:
        """(host batch, pad_weight), built by `num_workers` threads at most
        `num_workers + prefetch` batches ahead."""
        indices = self._indices()
        n_batches = len(self)
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def producer() -> None:
            # an exception travels through the queue: a producer that died
            # without its sentinel would leave the consumer waiting
            try:
                window = self.num_workers + self.prefetch
                with futures.ThreadPoolExecutor(self.num_workers) as pool:
                    jobs: "queue.Queue" = queue.Queue()
                    next_b = 0
                    while next_b < min(window, n_batches):
                        jobs.put(pool.submit(self._build, indices, next_b))
                        next_b += 1
                    while not jobs.empty():
                        job = jobs.get()
                        if stop.is_set():
                            for other in list(jobs.queue):
                                other.cancel()
                            return
                        q.put(job.result())
                        if next_b < n_batches:
                            jobs.put(pool.submit(self._build, indices,
                                                 next_b))
                            next_b += 1
                q.put(None)
            except BaseException as exc:  # noqa: BLE001 - re-raised below
                q.put(exc)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
            while thread.is_alive():
                # unblock a producer waiting on the bounded queue
                try:
                    q.get(timeout=0.1)
                except queue.Empty:
                    pass

    def __iter__(self) -> tp.Iterator[tp.Tuple[tp.Any, tp.Any]]:
        """(batch, pad_weight [B]): pad_weight is 0 on the rows that fill
        the trailing partial batch."""
        if self.device is None:
            yield from self._host_batches()
            return
        staging = _Staging() if self.device.type == "cuda" else None
        for batch, pad_weight in self._host_batches():
            if staging is None:
                arrays = to_device(batch, self.device, self.assemble_dtype)
                weight = torch.from_numpy(pad_weight).to(self.device)
            else:
                arrays, weight = staging.send(batch, pad_weight, self.device,
                                              self.assemble_dtype)
            yield dataclasses.replace(batch, **arrays), weight
