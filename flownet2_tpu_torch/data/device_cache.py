"""Device-resident sample cache (flownet2_tpu/data/device_cache.py): training
batches drawn by index from a ring of sample slabs held on the device, with
a background thread that refreshes the slabs from the dataset.

- A **slab** is a dict of tensors of ``slab_samples`` samples in the
  transport domain of the packed records (uint8 images, int16 fixed-point
  flow, and ``occ`` / ``label`` where the items have them), about 2 MB a
  384x512 sample, on an explicit ``device``.
- Each training step gathers its batch from the slabs by index on the
  device (:func:`make_cache_gather_loss`), then decodes and augments it
  with freshly sampled coefficients, so repeated draws of one cached sample
  are still distinct training examples ("data echoing" with augmentation,
  Choi et al. 2019, arXiv:1907.05550). Per step only the indices and the
  coefficients cross to the device.
- The refresh thread rebuilds one slab at a time from the sample stream and
  swaps it in, so the cache is a rolling shuffled window of the dataset.

The host-side sampling of :class:`CacheBatches` and :class:`CacheChunks`
(``np.random.default_rng(seed)``, the same calls in the same order) is the
JAX module's, so from one seed both give the same indices and ``aug_*``
arrays.

**A swap on the card.** The JAX cache swaps references to immutable
arrays. Here the refresh thread stacks a slab in pinned host memory and
copies it with ``non_blocking=True`` on a CUDA stream of its own, records an
event there, and swaps the reference under the lock. A consumer that takes
slabs (:meth:`DeviceSampleCache.current_slabs`, :meth:`draw_slab`) makes
its current stream wait on each slab's event, so no step reads a slab
before its copy has landed. Each slab's tensors are marked used by the
consumer's stream (``record_stream``), so the caching allocator neither
frees nor reuses a swapped-out slab's memory before every step queued on
that stream when its last reference dropped has retired. No slab is ever
written in place after its upload.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Iterator, Optional

import numpy as np
import torch

from flownet2_tpu_torch.core.hostmem import tune_host_allocator


class DeviceSampleCache:
    """A ring of ``n_slabs`` slabs of ``slab_samples`` samples on ``device``,
    refreshed from ``sample_iter`` by a background thread.

    ``sample_iter`` yields sample dicts of HWC numpy arrays, all of one
    shape per field (``FlowRecordReader(transport=True)`` items through
    :func:`cycle_dataset`). ``device`` defaults to the current CUDA card;
    the tests name the CPU.

    Two throttles, the JAX module's:

    - ``min_echo``: a swap needs ``slab_samples * min_echo`` consumer draws
      (:meth:`note_drawn`) since the last one, so the refresh idles while
      training does not draw (start-up, evaluation), and a slab is not
      replaced before its samples could be drawn;
    - ``link_duty``: after a slab that took ``u`` seconds to build and
      upload, the thread sleeps ``u * (1 - link_duty) / link_duty``: the
      refresh holds the host and the link at most that share of the time.

    A finite stream ends the refresh; the cache keeps its last fill. An
    error in the refresh thread is raised to the consumer at its next
    :meth:`current_slabs` or :meth:`draw_slab`."""

    def __init__(
        self,
        sample_iter: Iterator[dict],
        *,
        slab_samples: int = 64,
        n_slabs: int = 4,
        refresh: bool = True,
        device=None,
        min_echo: float = 0.25,
        link_duty: float = 0.25,
    ):
        if slab_samples < 1 or n_slabs < 1:
            raise ValueError("slab_samples and n_slabs must be >= 1")
        if not 0 < link_duty <= 1:
            raise ValueError("link_duty must be in (0, 1]")
        # the refresh thread stacks a slab of host buffers (128 MB at 64
        # samples of 384x512) again and again
        tune_host_allocator()
        self._iter = sample_iter
        self.slab_samples = slab_samples
        self.n_slabs = n_slabs
        self.min_echo = min_echo
        self.link_duty = link_duty
        self.device = torch.device(device) if device is not None else torch.device("cuda", torch.cuda.current_device())
        self._cuda = self.device.type == "cuda"
        if self._cuda:
            self._consumer_stream = torch.cuda.current_stream(self.device)
            self._copy_stream = torch.cuda.Stream(self.device)
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._error: Optional[BaseException] = None
        self._next_swap = 0
        self.samples_uploaded = 0
        self.slabs_swapped = 0
        self.bytes_uploaded = 0
        self.samples_drawn = 0
        self._drawn_at_last_swap = 0
        # the first fill, before the first draw; each entry (slab, event)
        self._slabs = [self._build_and_upload() for _ in range(n_slabs)]
        self._thread: Optional[threading.Thread] = None
        if refresh:
            self._thread = threading.Thread(target=self._refresh_loop, daemon=True)
            self._thread.start()

    # -- the refresh side ------------------------------------------------
    def _build_slab_host(self) -> dict:
        """The next ``slab_samples`` samples stacked per field, in pinned
        memory when the slab goes to a card."""
        samples = [next(self._iter) for _ in range(self.slab_samples)]
        host = {}
        for key in samples[0]:
            first = np.asarray(samples[0][key])
            shape = (self.slab_samples,) + first.shape
            if self._cuda:
                dtype = torch.from_numpy(np.empty(0, first.dtype)).dtype
                buf = torch.empty(shape, dtype=dtype, pin_memory=True)
            else:
                buf = torch.from_numpy(np.empty(shape, first.dtype))
            rows = buf.numpy()
            for i, s in enumerate(samples):
                rows[i] = s[key]
            host[key] = buf
        return host

    def _build_and_upload(self) -> tuple[dict, Optional[torch.cuda.Event]]:
        host = self._build_slab_host()
        event = None
        if self._cuda:
            with torch.cuda.stream(self._copy_stream):
                slab = {k: v.to(self.device, non_blocking=True) for k, v in host.items()}
                for v in slab.values():
                    v.record_stream(self._consumer_stream)
                event = torch.cuda.Event()
                event.record(self._copy_stream)
        else:
            slab = {k: v.to(self.device) for k, v in host.items()}
        self.samples_uploaded += self.slab_samples
        self.bytes_uploaded += sum(v.nbytes for v in host.values())
        return slab, event

    def _refresh_loop(self) -> None:
        need = max(1, int(self.slab_samples * self.min_echo))
        while not self._stop.is_set():
            # the echo cap: wait until the consumer drew enough since the
            # last swap that replacing a slab can matter
            while self.samples_drawn - self._drawn_at_last_swap < need:
                if self._stop.wait(0.05):
                    return
            t0 = time.monotonic()
            try:
                entry = self._build_and_upload()
            except StopIteration:
                return  # a finite stream ran out: the cache keeps its last fill
            except Exception as e:  # handed to the consumer at its next draw
                self._error = e
                return
            upload_s = time.monotonic() - t0
            with self._lock:
                i = self._next_swap
                self._next_swap = (i + 1) % self.n_slabs
                self._slabs[i] = entry
                self.slabs_swapped += 1
                self._drawn_at_last_swap = self.samples_drawn
            # the duty cap: leave the host and the link to training
            if self.link_duty < 1 and self._stop.wait(upload_s * (1 - self.link_duty) / self.link_duty):
                return

    # -- the consumer side -----------------------------------------------
    def _take(self, entries: list) -> list[dict]:
        """The slabs of ``entries``, after the current stream was made to
        wait for their uploads."""
        if self._error is not None:
            raise RuntimeError("device cache: the refresh thread failed") from self._error
        if self._cuda:
            stream = torch.cuda.current_stream(self.device)
            for _, event in entries:
                stream.wait_event(event)
        return [slab for slab, _ in entries]

    def note_drawn(self, n: int) -> None:
        """Report ``n`` samples drawn by the consumer (feeds the echo cap)."""
        self.samples_drawn += n  # one writer; the refresh thread only reads

    def draw_slab(self, rng: np.random.Generator) -> dict:
        """A uniformly drawn current slab, ready for the current stream."""
        with self._lock:
            entry = self._slabs[int(rng.integers(self.n_slabs))]
        return self._take([entry])[0]

    def current_slabs(self) -> tuple:
        """All current slabs, one consistent snapshot, ready for the current
        stream (a chunk's indices address their concatenation in this
        order)."""
        with self._lock:
            entries = list(self._slabs)
        return tuple(self._take(entries))

    def stats(self) -> dict:
        return {
            "slabs_swapped": self.slabs_swapped,
            "samples_uploaded": self.samples_uploaded,
            "bytes_uploaded": self.bytes_uploaded,
            "capacity_samples": self.slab_samples * self.n_slabs,
            "samples_drawn": self.samples_drawn,
        }

    def stop(self, timeout: float = 30.0) -> None:
        """End the refresh and wait for its thread (up to ``timeout`` s)."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()


def cycle_dataset(dataset, *, seed: Optional[int] = 0, block_size: int = 1) -> Iterator[dict]:
    """An endless sample stream over ``dataset``, reshuffled each epoch with
    the datasets' block-wise permutation (epoch e uses seed + e) where the
    dataset has one; file order with ``seed`` None."""
    epoch = 0
    while True:
        if seed is not None and hasattr(dataset, "permutation"):
            order = dataset.permutation(seed + epoch, block_size)
        else:
            order = np.arange(len(dataset))
        for i in order:
            yield dataset[int(i)]
        epoch += 1


class CacheBatches:
    """Batches for ``Solver.solve`` from a :class:`DeviceSampleCache`: each
    batch is ``{cache_<field>: one drawn slab's tensors, cache_idx: (batch,)
    int32 indices into it, aug_*: host coefficient arrays}``. Pair it with
    :func:`make_cache_gather_loss`, which gathers the batch on the device.

    Draws: the slab (``rng.integers``), then the indices (``rng.choice``,
    without replacement when the batch fits the slab), then
    ``aug_sampler(rng, batch_size)``."""

    def __init__(
        self,
        cache: DeviceSampleCache,
        batch_size: int,
        *,
        seed: int = 0,
        aug_sampler: Optional[Callable[[np.random.Generator, int], dict]] = None,
    ):
        self.cache = cache
        self.batch_size = batch_size
        self.aug_sampler = aug_sampler
        self._rng = np.random.default_rng(seed)

    def __iter__(self):
        while True:
            slab = self.cache.draw_slab(self._rng)
            idx = self._rng.choice(
                self.cache.slab_samples, size=self.batch_size, replace=self.batch_size > self.cache.slab_samples
            ).astype(np.int32)
            batch = {f"cache_{k}": v for k, v in slab.items()}
            batch["cache_idx"] = idx
            if self.aug_sampler is not None:
                batch.update(self.aug_sampler(self._rng, self.batch_size))
            self.cache.note_drawn(self.batch_size)
            yield batch


class CacheChunks:
    """K-step banks for ``Solver.solve_cached`` /
    ``train.solver.make_multistep_train_step`` from a
    :class:`DeviceSampleCache`: yields ``(slabs, bank)``, the cache's current
    slab tuple and a host dict of per-step arrays with leading axis K:
    ``cache_idx`` (K, batch) int32 indices into the slabs' concatenation in
    slab order, and the ``aug_*`` arrays reshaped to (K, batch, ...).

    Unlike :class:`CacheBatches`, a chunk's batches mix samples of all the
    slabs, and a refresh lands between chunks. Draws: the indices
    (``rng.integers`` over the whole cache, with replacement), then
    ``aug_sampler(rng, K * batch)``."""

    def __init__(
        self,
        cache: DeviceSampleCache,
        batch_size: int,
        steps_per_dispatch: int,
        *,
        seed: int = 0,
        aug_sampler: Optional[Callable[[np.random.Generator, int], dict]] = None,
    ):
        if steps_per_dispatch < 1:
            raise ValueError("steps_per_dispatch must be >= 1")
        self.cache = cache
        self.batch_size = batch_size
        self.steps_per_dispatch = steps_per_dispatch
        self.aug_sampler = aug_sampler
        self._rng = np.random.default_rng(seed)

    def __iter__(self):
        k, n = self.steps_per_dispatch, self.batch_size
        while True:
            slabs = self.cache.current_slabs()
            total = len(slabs) * self.cache.slab_samples
            bank = {"cache_idx": self._rng.integers(0, total, size=(k, n)).astype(np.int32)}
            if self.aug_sampler is not None:
                arrays = self.aug_sampler(self._rng, k * n)
                bank.update({name: v.reshape((k, n) + v.shape[1:]) for name, v in arrays.items()})
            self.cache.note_drawn(k * n)
            yield slabs, bank


def make_cache_gather_loss(inner_loss: Callable) -> Callable:
    """Wrap ``inner_loss(net, batch)`` so that it first assembles the batch
    from the slab tensors: ``batch[k] = batch["cache_" + k][batch["cache_idx"]]``
    for every cached field, by ``index_select`` on the slab's device. Wrap it
    around ``make_augmented_loss``: gather, decode, augment, net."""

    def loss_fn(net, batch):
        b = dict(batch)
        idx = torch.as_tensor(b.pop("cache_idx"))
        for key in [k for k in b if k.startswith("cache_")]:
            src = b.pop(key)
            b[key[len("cache_"):]] = src.index_select(0, idx.to(src.device))
        return inner_loss(net, b)

    return loss_fn
