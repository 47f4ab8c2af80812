"""Prefetching batch loader (flownet2_tpu/data/pipeline.py): the
DataReader/BlockingQueue analogue of the reference.

Worker threads decode samples and stack them into host batches; a bounded
queue holds the ready batches, so host decoding overlaps the device step.
The sample order (with the datasets' block-wise permutation) and the
workers' random generators are seeded as in the JAX loader, so the two give
the same batches for the same seed. Batches keep the items' dtypes: packed
records read in transport mode stack as uint8 images and int16 flow, which
the objectives decode on the device (``core/codec.flow_as_f32``).
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator, Optional

import numpy as np


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
    dropping a last partial batch."""

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
        transform: Optional[Callable[[dict, np.random.Generator], dict]] = None,
    ):
        if len(dataset) == 0:
            raise ValueError("BatchLoader: empty dataset")
        self.dataset = dataset
        self.batch_size = batch_size
        self.crop = crop
        self.shuffle_seed = shuffle_seed
        self.block_size = block_size
        self.num_threads = num_threads
        self.prefetch = prefetch
        self.epochs = epochs
        self.transform = transform

    def _index_stream(self) -> Iterator[int]:
        epoch = 0
        while self.epochs is None or epoch < self.epochs:
            if self.shuffle_seed is not None and hasattr(self.dataset, "permutation"):
                order = self.dataset.permutation(self.shuffle_seed + epoch, self.block_size)
            else:
                order = np.arange(len(self.dataset))
            yield from order
            epoch += 1

    def _center_crop(self, arr):
        """``arr`` center-cropped to ``crop``; a per-sample scalar (an LMDB
        item's label) passes through."""
        if self.crop is None or np.ndim(arr) < 2:
            return arr
        ch, cw = self.crop
        h, w = arr.shape[:2]
        if (h, w) == (ch, cw):
            return arr
        if h < ch or w < cw:
            raise ValueError(f"sample {h}x{w} smaller than crop {ch}x{cw}")
        y0 = (h - ch) // 2
        x0 = (w - cw) // 2
        return arr[y0 : y0 + ch, x0 : x0 + cw]

    def __iter__(self) -> Iterator[dict]:
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
                    samples = [self.dataset[int(i)] for i in items]
                    samples = [{k: self._center_crop(v) for k, v in s.items()} for s in samples]
                    batch = {k: np.stack([s[k] for s in samples]) for k in samples[0]}
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
