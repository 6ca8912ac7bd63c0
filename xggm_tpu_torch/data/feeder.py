"""Feeder: background batch assembly and host-to-device copies (counterpart
of `xggm_tpu/data/feeder.py::Feeder`, for one process).

A producer thread assembles each batch with `GraphBatchDataset.get_batch`,
pads the last partial one to the batch size (with a validity mask), fills
pinned host tensors and, on a CUDA device, starts their copies on a side
stream and records an event. The consumer's stream waits on that event, so
the copy of batch N+1 overlaps the step of batch N. On the CPU it yields
plain CPU tensors. Token ids, masks and segment ids are int64; the features
are cast on the host to `feats_dtype` (bf16 when the model computes in bf16,
halving the bytes copied); the rest is float32.
"""
from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, Optional, Tuple, Union

import numpy as np
import torch

from xggm_tpu_torch.data.datasets import GraphBatchDataset
from xggm_tpu_torch.utils.device import resolve_device

_INT_KEYS = ("input_ids", "input_mask", "segment_ids")


def pad_batch_to(batch: Dict[str, np.ndarray], size: int
                 ) -> Tuple[Dict[str, np.ndarray], np.ndarray]:
    """Pad every array's leading dim to `size` with zeros at the end;
    returns (padded, valid_mask)."""
    n = next(iter(batch.values())).shape[0]
    if n > size:
        raise ValueError(f"batch of {n} exceeds the padded size {size}")
    if n == size:
        return batch, np.ones((n,), np.bool_)
    mask = np.zeros((size,), np.bool_)
    mask[:n] = True
    padded = {k: np.pad(x, [(0, size - n)] + [(0, 0)] * (x.ndim - 1))
              for k, x in batch.items()}
    return padded, mask


class Feeder:
    """Iterates a `GraphBatchDataset` in batches of `batch_size`: yields
    (question_ids, batch of tensors on `device`, valid_mask)."""

    def __init__(self, dataset: GraphBatchDataset, batch_size: int,
                 shuffle: bool = False, drop_last: bool = False,
                 seed: int = 9595, prefetch_depth: int = 2,
                 feats_dtype: Optional[torch.dtype] = None,
                 device: Union[str, torch.device] = "cuda"):
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

    def __iter__(self):
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch_depth)
        sentinel = object()
        stop = threading.Event()
        skip, self._skip_next = self._skip_next, 0
        cuda = self.device.type == "cuda"
        copy_stream = torch.cuda.Stream(self.device) if cuda else None

        def producer():
            try:
                for j, idx in enumerate(self._index_batches()):
                    if stop.is_set():
                        return
                    if j < skip:
                        continue
                    qids = self.dataset.question_ids(idx)
                    batch, mask = pad_batch_to(self.dataset.get_batch(idx),
                                               self.batch_size)
                    host = self._host_tensors(batch)
                    event = None
                    if cuda:
                        # the caching host allocator keeps each pinned
                        # buffer until the copy that reads it has run
                        with torch.cuda.stream(copy_stream):
                            host = {k: t.to(self.device, non_blocking=True)
                                    for k, t in host.items()}
                            event = torch.cuda.Event()
                            event.record(copy_stream)
                    q.put((qids, host, mask, event))
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
                if isinstance(item, BaseException):
                    raise RuntimeError(
                        "feeder producer thread failed while assembling a "
                        "batch") from item
                qids, batch, mask, event = item
                if event is not None:
                    stream = torch.cuda.current_stream(self.device)
                    stream.wait_event(event)
                    for v in batch.values():
                        # made on the copy stream, used on this one
                        v.record_stream(stream)
                yield qids, batch, mask
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
