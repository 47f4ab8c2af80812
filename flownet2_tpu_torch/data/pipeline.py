"""Prefetching batch loader (flownet2_tpu/data/pipeline.py): the
DataReader/BlockingQueue analogue of the reference.

Worker threads decode samples and stack them into host batches; a bounded
queue holds the ready batches, so host decoding overlaps the device step.
The sample order and the workers' random generators are seeded as in the
JAX loader, so the two give the same batches for the same seed.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator, Optional

import numpy as np

PREFETCH = 4  # ready batches the queue holds


class BatchLoader:
    """Iterates batches {img0, img1, flow} of stacked (N, H, W, C) float32
    numpy arrays, prefetched by ``num_threads`` background threads.

    ``crop`` center-crops every sample to (h, w); ``shuffle_seed`` seeds the
    per-epoch permutation (epoch e uses seed + e; None keeps file order);
    ``transform(batch, rng)`` runs on each batch in its worker, with that
    worker's generator. Epochs run back to back without end."""

    def __init__(
        self,
        dataset,
        batch_size: int,
        *,
        crop: Optional[tuple[int, int]] = None,
        shuffle_seed: Optional[int] = 0,
        num_threads: int = 2,
        transform: Optional[Callable[[dict, np.random.Generator], dict]] = None,
    ):
        if len(dataset) == 0:
            raise ValueError("BatchLoader: empty dataset")
        self.dataset = dataset
        self.batch_size = batch_size
        self.crop = crop
        self.shuffle_seed = shuffle_seed
        self.num_threads = num_threads
        self.transform = transform

    def _index_stream(self) -> Iterator[int]:
        epoch = 0
        while True:
            if self.shuffle_seed is not None and hasattr(self.dataset, "permutation"):
                order = self.dataset.permutation(self.shuffle_seed + epoch)
            else:
                order = np.arange(len(self.dataset))
            yield from order
            epoch += 1

    def _center_crop(self, arr: np.ndarray) -> np.ndarray:
        if self.crop is None:
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
        out_q: queue.Queue = queue.Queue(maxsize=PREFETCH)
        stop = threading.Event()

        def worker(wid: int):
            rng = np.random.default_rng((self.shuffle_seed or 0) * 1000 + wid)
            while not stop.is_set():
                with idx_lock:
                    items = [next(idx_iter) for _ in range(self.batch_size)]
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

        threads = [threading.Thread(target=worker, args=(i,), daemon=True) for i in range(self.num_threads)]
        for t in threads:
            t.start()
        try:
            while True:
                item = out_q.get()
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
