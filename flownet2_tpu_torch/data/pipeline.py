"""Prefetching batch loader (flownet2_tpu/data/pipeline.py): the
DataReader/BlockingQueue analogue of the reference.

Worker threads decode samples and stack them into host batches; a bounded
queue holds the ready batches, so host decoding overlaps the device step.
The sample order (with the datasets' block-wise permutation) and the
workers' random generators are seeded as in the JAX loader, so the two give
the same batches for the same seed. Batches keep the items' dtypes: packed
records read in transport mode stack as uint8 images and int16 flow, which
the objectives decode on the device (``core/codec.flow_as_f32``).

With ``shard=(rank, world)`` the loader is keyed, for data-parallel
training: global batch k is a function of k alone, whichever thread makes
it, so that the ranks of a group cut one global batch between them.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator, Optional

import numpy as np


def center_crop(arr, crop: Optional[tuple[int, int]]):
    """``arr`` (H, W, ...) center-cropped to ``crop`` (h, w); ``crop`` None
    and a per-sample scalar (an LMDB item's label) pass through."""
    if crop is None or np.ndim(arr) < 2:
        return arr
    ch, cw = crop
    h, w = arr.shape[:2]
    if (h, w) == (ch, cw):
        return arr
    if h < ch or w < cw:
        raise ValueError(f"sample {h}x{w} smaller than crop {ch}x{cw}")
    y0 = (h - ch) // 2
    x0 = (w - cw) // 2
    return arr[y0 : y0 + ch, x0 : x0 + cw]


class BatchLoader:
    """Iterates batches {img0, img1, flow[, occ, label]} of the items' arrays
    stacked to (N, H, W, C), prefetched by ``num_threads`` background threads
    into a queue of ``prefetch`` ready batches.

    ``crop`` center-crops every sample to (h, w); ``shuffle_seed`` seeds the
    per-epoch permutation (epoch e uses seed + e; None keeps file order),
    permuted in contiguous blocks of ``block_size`` samples (the CustomData
    block shuffle); ``transform(batch, rng)`` runs on each batch in its
    worker, with that worker's generator. ``epochs`` None runs epochs back to
    back without end; a count ends the iteration after that many epochs,
    dropping a last partial batch.

    ``shard=(rank, world)`` keys the batches: ``batch_size`` is the global
    batch B, global batch k takes positions [k*B, (k+1)*B) of the epochs'
    permutations laid end to end, and its generator is seeded with
    (``shuffle_seed``, k). This rank decodes only its rows [rank*b,
    (rank+1)*b) of it, b = B / world, and the transform is called as
    ``transform(batch, rng, rows=(rank*b, (rank+1)*b, B))``, so that it
    draws the global batch's coefficients and keeps this rank's rows.
    Batches come out in the order of k with any number of threads.
    ``(0, 1)`` is the keyed loader of one process."""

    def __init__(
        self,
        dataset,
        batch_size: int,
        *,
        crop: Optional[tuple[int, int]] = None,
        shuffle_seed: Optional[int] = 0,
        block_size: int = 1,
        num_threads: int = 2,
        prefetch: int = 4,
        epochs: Optional[int] = None,
        transform: Optional[Callable[..., dict]] = None,
        shard: Optional[tuple[int, int]] = None,
    ):
        from flownet2_tpu_torch.core.hostmem import tune_host_allocator

        # the prefetch ring churns batch-sized host buffers every step;
        # without this, glibc maps and unmaps each one (a page-zeroing tax)
        tune_host_allocator()
        if len(dataset) == 0:
            raise ValueError("BatchLoader: empty dataset")
        if shard is not None and (batch_size % shard[1] or not 0 <= shard[0] < shard[1]):
            raise ValueError(f"BatchLoader: shard {shard} does not cut a global batch of {batch_size} evenly")
        self.dataset = dataset
        self.batch_size = batch_size
        self.crop = crop
        self.shuffle_seed = shuffle_seed
        self.block_size = block_size
        self.num_threads = num_threads
        self.prefetch = prefetch
        self.epochs = epochs
        self.transform = transform
        self.shard = shard

    def _epoch_order(self, epoch: int) -> np.ndarray:
        if self.shuffle_seed is not None and hasattr(self.dataset, "permutation"):
            return self.dataset.permutation(self.shuffle_seed + epoch, self.block_size)
        return np.arange(len(self.dataset))

    def _index_stream(self) -> Iterator[int]:
        epoch = 0
        while self.epochs is None or epoch < self.epochs:
            yield from self._epoch_order(epoch)
            epoch += 1

    def _keyed_indices(self, k: int, orders: dict) -> Optional[list[int]]:
        """This rank's sample indices of global batch k (None past the last
        epoch); ``orders`` caches the epochs' permutations."""
        rank, world = self.shard
        b, n = self.batch_size // world, len(self.dataset)
        start = k * self.batch_size + rank * b
        if self.epochs is not None and (k + 1) * self.batch_size > self.epochs * n:
            return None
        out = []
        for pos in range(start, start + b):
            epoch = pos // n
            if epoch not in orders:
                orders[epoch] = self._epoch_order(epoch)
                orders.pop(epoch - 2, None)
            out.append(int(orders[epoch][pos % n]))
        return out

    def _make_batch(self, items: list[int]) -> dict:
        samples = [self.dataset[int(i)] for i in items]
        samples = [{k: self._center_crop(v) for k, v in s.items()} for s in samples]
        return {k: np.stack([s[k] for s in samples]) for k in samples[0]}

    def _center_crop(self, arr):
        return center_crop(arr, self.crop)

    def __iter__(self) -> Iterator[dict]:
        if self.shard is not None:
            yield from self._iter_keyed()
            return
        idx_iter = self._index_stream()
        idx_lock = threading.Lock()
        out_q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        n_done = [0]
        done_lock = threading.Lock()

        def worker(wid: int):
            rng = np.random.default_rng((self.shuffle_seed or 0) * 1000 + wid)
            while not stop.is_set():
                items = []
                with idx_lock:
                    for i in idx_iter:
                        items.append(i)
                        if len(items) == self.batch_size:
                            break
                if len(items) < self.batch_size:
                    break
                try:
                    batch = self._make_batch(items)
                    if self.transform is not None:
                        batch = self.transform(batch, rng)
                    out_q.put(batch)
                except Exception as e:  # hand decode errors to the consumer
                    out_q.put(e)
                    break
            with done_lock:  # the last worker to finish ends the iteration
                n_done[0] += 1
                if n_done[0] == self.num_threads:
                    out_q.put(None)

        threads = [threading.Thread(target=worker, args=(i,), daemon=True) for i in range(self.num_threads)]
        for t in threads:
            t.start()
        try:
            while True:
                item = out_q.get()
                if item is None:
                    break
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()
            # drain so workers blocked on put() can exit
            while not out_q.empty():
                try:
                    out_q.get_nowait()
                except queue.Empty:
                    break

    def _iter_keyed(self) -> Iterator[dict]:
        """The keyed mode: threads take the next k under a lock and make this
        rank's rows of global batch k; the consumer hands them out in the
        order of k."""
        rank, world = self.shard
        b = self.batch_size // world
        rows = (rank * b, (rank + 1) * b, self.batch_size)
        next_k = [0]
        lock = threading.Lock()
        orders: dict = {}
        out_q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def worker():
            while not stop.is_set():
                with lock:
                    k = next_k[0]
                    next_k[0] += 1
                    items = self._keyed_indices(k, orders)
                if items is None:
                    out_q.put((k, None))
                    return
                try:
                    batch = self._make_batch(items)
                    if self.transform is not None:
                        rng = np.random.default_rng([self.shuffle_seed or 0, k])
                        batch = self.transform(batch, rng, rows=rows)
                    out_q.put((k, batch))
                except Exception as e:  # hand decode errors to the consumer
                    out_q.put((k, e))
                    return

        threads = [threading.Thread(target=worker, daemon=True) for _ in range(self.num_threads)]
        for t in threads:
            t.start()
        ready: dict = {}
        want = 0
        try:
            while True:
                while want not in ready:
                    k, item = out_q.get()
                    ready[k] = item
                item = ready.pop(want)
                if item is None:
                    break
                if isinstance(item, Exception):
                    raise item
                yield item
                want += 1
        finally:
            stop.set()
            while not out_q.empty():  # drain so workers blocked on put() can exit
                try:
                    out_q.get_nowait()
                except queue.Empty:
                    break
