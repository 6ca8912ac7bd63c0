"""Feeders: background batch assembly and host-to-device copies
(counterpart of `xggm_tpu/data/feeder.py`).

A producer thread assembles each batch with `GraphBatchDataset.get_batch`,
pads the last partial one to the batch size (with a validity mask), fills
pinned host tensors and, on a CUDA device, starts their copies on a side
stream and records an event. The consumer's stream waits on that event, so
the copy of batch N+1 overlaps the step of batch N. On the CPU it yields
plain CPU tensors. Token ids, masks and segment ids are int64; the features
are cast on the host to `feats_dtype` (bf16 when the model computes in bf16,
halving the bytes copied); the rest is float32.

Under data parallelism (`process_count` > 1) `batch_size` stays the global
batch: every rank draws the same index batches from the same shuffled order
and assembles only its `process_slice` of each. The last eval batch is
padded in its index list (the last row repeated, masked out) to the global
size before the slice, so every rank gets as many rows. The question ids
and the mask stay global; `parallel/distributed.py::to_host` gathers the
ranks' predictions in the same order.

`MultiEpochsFeeder` keeps one producer across epochs, and `Prefetcher`
gives any of them a pull API; nothing in the trainer uses either.
"""
from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, Optional, Tuple, Union

import numpy as np
import torch

from xggm_tpu_torch.data.datasets import GraphBatchDataset
from xggm_tpu_torch.parallel.distributed import process_slice
from xggm_tpu_torch.parallel.mesh import pad_batch_to
from xggm_tpu_torch.utils.device import resolve_device

_INT_KEYS = ("input_ids", "input_mask", "segment_ids")


class Feeder:
    """Iterates a `GraphBatchDataset` in batches of `batch_size`: yields
    (question_ids, batch of tensors on `device`, valid_mask); under data
    parallelism the tensors hold this rank's rows only."""

    def __init__(self, dataset: GraphBatchDataset, batch_size: int,
                 shuffle: bool = False, drop_last: bool = False,
                 seed: int = 9595, prefetch_depth: int = 2,
                 feats_dtype: Optional[torch.dtype] = None,
                 device: Union[str, torch.device] = "cuda",
                 process_index: int = 0, process_count: int = 1):
        if batch_size % process_count:
            raise ValueError(f"global batch {batch_size} not divisible by "
                             f"process_count {process_count}")
        self.process_index = process_index
        self.process_count = process_count
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.prefetch_depth = prefetch_depth
        self.feats_dtype = feats_dtype or torch.float32
        self.device = resolve_device(device)
        self._epoch = 0
        self._skip_next = 0

    def set_position(self, epoch: int, skip_batches: int = 0) -> None:
        """Align the per-epoch shuffle to `epoch` and drop the first
        `skip_batches` index batches of the next iteration."""
        self._epoch = epoch
        self._skip_next = skip_batches

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _index_batches(self) -> Iterator[np.ndarray]:
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            np.random.RandomState(self.seed + self._epoch).shuffle(order)
        stop = (n // self.batch_size) * self.batch_size if self.drop_last else n
        for start in range(0, stop, self.batch_size):
            yield order[start:start + self.batch_size]

    def _host_tensors(self, batch: Dict[str, np.ndarray]
                      ) -> Dict[str, torch.Tensor]:
        """The batch as host tensors of the types the model takes, pinned
        when they go to a CUDA device."""
        pin = self.device.type == "cuda"
        out = {}
        for k, x in batch.items():
            dtype = (torch.int64 if k in _INT_KEYS else
                     self.feats_dtype if k == "feats" else torch.float32)
            t = torch.empty(x.shape, dtype=dtype, pin_memory=pin)
            t.copy_(torch.from_numpy(x))
            out[k] = t
        return out

    def _assemble(self, idx: np.ndarray, copy_stream) -> tuple:
        """Batch `idx`, padded (this rank's rows of it): (question ids,
        tensors, valid mask, event).
        With a copy stream (a CUDA device), the tensors are the device
        copies started on it and the event follows them."""
        qids = self.dataset.question_ids(idx)
        if self.process_count > 1:
            mask = np.zeros((self.batch_size,), np.bool_)
            mask[:len(idx)] = True
            padded = np.concatenate(
                [idx, np.repeat(idx[-1:], self.batch_size - len(idx))])
            batch = self.dataset.get_batch(process_slice(
                padded, self.process_index, self.process_count))
        else:
            batch, mask = pad_batch_to(self.dataset.get_batch(idx),
                                       self.batch_size)
        host = self._host_tensors(batch)
        if copy_stream is None:
            return qids, host, mask, None
        # the caching host allocator keeps each pinned buffer until the
        # copy that reads it has run
        with torch.cuda.stream(copy_stream):
            dev = {k: t.to(self.device, non_blocking=True)
                   for k, t in host.items()}
            event = torch.cuda.Event()
            event.record(copy_stream)
        return qids, dev, mask, event

    def _deliver(self, item):
        """(question ids, tensors, mask) of an assembled item, its copies
        ordered before the current stream's next work; re-raises a
        producer's error."""
        if isinstance(item, BaseException):
            raise RuntimeError("feeder producer thread failed while "
                               "assembling a batch") from item
        qids, batch, mask, event = item
        if event is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(event)
            for v in batch.values():
                # made on the copy stream, used on this one
                v.record_stream(stream)
        return qids, batch, mask

    def _copy_stream(self):
        return (torch.cuda.Stream(self.device)
                if self.device.type == "cuda" else None)

    def __iter__(self):
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch_depth)
        sentinel = object()
        stop = threading.Event()
        skip, self._skip_next = self._skip_next, 0
        copy_stream = self._copy_stream()

        def producer():
            try:
                for j, idx in enumerate(self._index_batches()):
                    if stop.is_set():
                        return
                    if j < skip:
                        continue
                    q.put(self._assemble(idx, copy_stream))
            except BaseException as e:  # noqa: BLE001 - re-raised below
                # a swallowed producer error would silently truncate the
                # epoch; hand it to the consumer instead
                q.put(e)
            else:
                q.put(sentinel)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is sentinel:
                    break
                yield self._deliver(item)
        finally:
            # on an early exit, unblock the producer and let it end
            stop.set()
            while t.is_alive():
                try:
                    q.get(timeout=0.05)
                except queue.Empty:
                    pass
            t.join()
        self._epoch += 1


class Prefetcher:
    """A pull API with one batch of lookahead over any iterable of batches
    (the reference's `DataPrefetcher`): `next()` returns the batch it holds
    and takes the next one, and None once the iterable is exhausted. The
    `Feeder` already assembles and copies ahead on its producer thread;
    this keeps the calling convention of code written against the
    reference."""

    def __init__(self, loader):
        self._it = iter(loader)
        self._preload()

    def _preload(self):
        try:
            self.batch = next(self._it)
        except StopIteration:
            self.batch = None

    def next(self):
        batch = self.batch
        if batch is not None:
            self._preload()
        return batch


class MultiEpochsFeeder(Feeder):
    """A `Feeder` whose one producer thread streams epoch after epoch
    through one queue (the reference's `MultiEpochsDataLoader`), so an
    epoch does not pay the producer's start-up again. Each `__iter__`
    yields exactly `len(self)` batches (one epoch) and leaves the stream
    running; the shuffle still advances per epoch (seed + epoch), batch
    for batch as `Feeder`'s. The batches are placed as `Feeder` places
    them: pinned host tensors, copied on one side stream."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._q = None
        self._thread = None

    def _producer_loop(self, copy_stream):
        try:
            while True:
                for idx in self._index_batches():
                    self._q.put(self._assemble(idx, copy_stream))
                self._epoch += 1
        except BaseException as e:  # noqa: BLE001 - re-raised in __iter__
            self._q.put(e)

    def __iter__(self):
        if self._thread is None:
            self._q = queue.Queue(maxsize=self.prefetch_depth)
            self._thread = threading.Thread(
                target=self._producer_loop, args=(self._copy_stream(),),
                daemon=True)
            self._thread.start()
        for _ in range(len(self)):
            yield self._deliver(self._q.get())
