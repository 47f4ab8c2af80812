"""Prefetching batch loader and device staging (flownet2_tpu/data/pipeline.py):
the DataReader/BlockingQueue analogue of the reference.

Worker threads decode samples and stack them into host batches; a bounded
queue holds the ready batches, so host decoding overlaps the device step.
:class:`DevicePrefetcher` then stages each batch on the card from a thread
of its own, so the training loop never waits for an upload.
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
import torch


def pack_layout(arrays: dict) -> tuple[dict, int]:
    """Byte offsets of ``arrays`` laid end to end in one block, each 8-byte
    aligned so that it can be viewed in its type, and the block's size."""
    offsets, total = {}, 0
    for k, a in arrays.items():
        total = -(-total // 8) * 8
        offsets[k] = total
        total += a.nbytes
    return offsets, total


def pack_into(block: torch.Tensor, arrays: dict, offsets: dict) -> None:
    """Copy ``arrays`` into the uint8 host tensor ``block`` at ``offsets``."""
    raw = block.numpy()
    for k, a in arrays.items():
        raw[offsets[k]:offsets[k] + a.nbytes] = a.reshape(-1).view(np.uint8)


def unpack_views(block: torch.Tensor, arrays: dict, offsets: dict) -> dict:
    """Views of the uint8 tensor ``block`` (any device) in the types and
    shapes of ``arrays`` packed at ``offsets``."""
    return {
        k: block[offsets[k]:offsets[k] + a.nbytes].view(torch.from_numpy(np.empty(0, a.dtype)).dtype).view(a.shape)
        for k, a in arrays.items()
    }


class _Staged:
    """A batch of card tensors whose copy was queued on the staging stream,
    and the event recorded after it."""

    def __init__(self, tensors: dict, event: torch.cuda.Event):
        self.tensors = tensors
        self.event = event

    def take(self, device: torch.device) -> dict:
        """The tensors, ready for the current stream: it waits for the copy
        on the card (the host does not), and each tensor is marked used by
        it, so the caching allocator does not hand its memory to the
        staging stream again before the work queued here has retired."""
        stream = torch.cuda.current_stream(device)
        stream.wait_event(self.event)
        for t in self.tensors.values():
            t.record_stream(stream)
        return self.tensors


class _CardStager:
    """Packs a batch's arrays into one pinned host block of a ring of
    ``slots`` and copies it to ``device`` on a stream of its own. A block is
    refilled only after its last copy's event has completed; the thread
    that stages waits for it, never the consumer."""

    def __init__(self, device: torch.device, slots: int):
        self.device = device
        self.stream = torch.cuda.Stream(device)
        self.ring: list = [(None, None)] * slots  # (pinned block, event of its last copy)
        self.next = 0

    def __call__(self, batch: dict) -> _Staged:
        arrays = {k: np.ascontiguousarray(v) for k, v in batch.items()}
        offsets, total = pack_layout(arrays)
        i, self.next = self.next, (self.next + 1) % len(self.ring)
        block, event = self.ring[i]
        if event is not None:
            event.synchronize()
        if block is None or block.numel() < total:
            block = torch.empty(total, dtype=torch.uint8, pin_memory=True)
        pack_into(block, arrays, offsets)
        with torch.cuda.device(self.device), torch.cuda.stream(self.stream):
            on_card = torch.empty(total, dtype=torch.uint8, device=self.device)
            on_card.copy_(block[:total], non_blocking=True)
            event = torch.cuda.Event()
            event.record(self.stream)
        self.ring[i] = (block, event)
        DevicePrefetcher.uploads += 1
        return _Staged(unpack_views(on_card, arrays, offsets), event)


class DevicePrefetcher:
    """Host-to-device staging: a background thread uploads batches ahead of
    consumption, so the copy overlaps the device step (the reference's
    ``async_gpu_push`` on SyncedMemory with its prefetch threads,
    syncedmem.hpp:45-83, base_data_layer.hpp:74-79).

    Wraps any iterator of dicts of arrays and yields the same dicts with
    every array a tensor on ``device``, in order. ``depth`` bounds the
    staged batches (card memory held: about ``depth`` + 1 batches). Upload
    stalls land in the staging thread, never in the training loop:

    - to a card, the thread packs each batch into one pinned host block of
      a ring of ``depth`` + 1, copies it with ``non_blocking=True`` on a
      CUDA stream of its own and records an event; the consumer's current
      stream waits for that event on the card, and every tensor is marked
      used by that stream (``record_stream``);
    - ``device="cpu"`` yields ``torch.from_numpy`` tensors of the arrays.

    ``device=None`` is the current CUDA card; without one it raises (it
    never falls back to the CPU). An error in the source or in an upload is
    raised at the consumer. Closing the generator stops the thread and
    drains the queue. ``uploads`` counts the batches staged to a card, over
    every instance."""

    uploads = 0

    def __init__(self, batches, *, depth: int = 2, device=None):
        if depth < 1:
            raise ValueError(f"DevicePrefetcher: depth must be >= 1, got {depth}")
        if device is None:
            if not torch.cuda.is_available():
                raise RuntimeError("DevicePrefetcher: no CUDA device available; name a device "
                                   "(device='cpu' stages on the host)")
            device = torch.device("cuda", torch.cuda.current_device())
        self.batches = batches
        self.depth = depth
        self.device = torch.device(device)

    def _host(self, batch: dict) -> dict:
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device) for k, v in batch.items()}

    def __iter__(self) -> Iterator[dict]:
        cuda = self.device.type == "cuda"
        stage = _CardStager(self.device, self.depth + 1) if cuda else self._host
        q: queue.Queue = queue.Queue(maxsize=self.depth)
        stop = threading.Event()

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.05)
                    return True
                except queue.Full:
                    pass
            return False

        def worker():
            try:
                for batch in self.batches:
                    if stop.is_set() or not put(stage(batch)):
                        return
            except Exception as e:  # a decode or upload error, raised at the consumer
                put(e)
                return
            put(None)

        thread = threading.Thread(target=worker, name="DevicePrefetcher", daemon=True)
        thread.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    break
                if isinstance(item, Exception):
                    raise item
                yield item.take(self.device) if cuda else item
        finally:
            stop.set()
            while not q.empty():  # drain, so that a put in flight returns
                try:
                    q.get_nowait()
                except queue.Empty:
                    break


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
