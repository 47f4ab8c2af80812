"""Data-parallel training over one process per device: the counterpart of
flownet2_tpu/parallel/data_parallel.py (``replicate``,
``REPLICATED_BATCH_KEYS``, ``batch_partition_specs`` and
``make_dp_train_step``).

Each rank computes the gradients of its rows of the global batch. After the
last backward of an iteration the trainable gradients are flattened into
one buffer and cross the group in ONE ``all_reduce`` (the reference's
``GPUParams`` flattens every learnable into one span for P2PSync,
parallel.cpp:26-56; the JAX package's one ``psum``, data_parallel.py:197).
The loss, the aux values and the ranks' requested signal actions cross in
one more small ``all_reduce`` (the JAX package's ``pmean`` of its stats,
:201). No ``DistributedDataParallel`` wrapper: its reducer syncs only
gradients produced through its own forward, and the objectives reach the
net in other ways (the stage losses call sub-nets, ``with_compute_dtype``
runs ``torch.func.functional_call``).
"""

from __future__ import annotations

import multiprocessing as mp
import queue
import time
from datetime import timedelta
from typing import Any, Callable, Optional, Sequence

import torch
import torch.distributed as dist
from torch import nn

from flownet2_tpu_torch.parallel.mesh import DEFAULT_TIMEOUT, Group, free_address, init_group

# Batch keys that carry state every rank needs whole rather than per-item
# rows: the running mean (H, W, C) and its counter, and a split stage
# loss's "frozen" subtree.
REPLICATED_BATCH_KEYS = frozenset({"mean_image0", "mean_image1", "mean_iter", "frozen"})


def broadcast_module(module: nn.Module, group: Group) -> None:
    """Give every rank rank 0's parameters and buffers (trainable and frozen
    alike), one flat broadcast per dtype: the JAX package's ``replicate``."""
    by_dtype: dict[torch.dtype, list[torch.Tensor]] = {}
    for t in [*module.parameters(), *module.buffers()]:
        by_dtype.setdefault(t.dtype, []).append(t)
    with torch.no_grad():
        for tensors in by_dtype.values():
            flat = torch.cat([t.reshape(-1) for t in tensors])
            dist.broadcast(flat, src=0)
            offset = 0
            for t in tensors:
                t.copy_(flat[offset : offset + t.numel()].view_as(t))
                offset += t.numel()


def rank_rows(batch: dict, rank: int, world: int, *, axis: int = 0) -> dict:
    """Rank ``rank``'s rows of a global host or device batch: per-item
    entries (dimension ``axis`` the batch size, read from ``img0``) are cut
    into ``world`` equal parts; replicated keys, scalars and entries of
    another length stay whole (``batch_partition_specs``' rule). ``axis`` is
    1 for a batch with a leading micro-batch axis (``iter_size`` > 1)."""
    n = batch["img0"].shape[axis]
    if n % world:
        raise ValueError(f"global batch {n} does not split into {world} equal parts")
    b = n // world

    def rows(key, x):
        if key in REPLICATED_BATCH_KEYS or x.ndim <= axis or x.shape[axis] != n:
            return x
        index = (slice(None),) * axis + (slice(rank * b, (rank + 1) * b),)
        return x[index]

    return {k: rows(k, v) for k, v in batch.items()}


def allreduce_gradients(params: Sequence[nn.Parameter], group: Group) -> None:
    """THE one gradient collective of a step: every gradient of ``params``
    (zeros where a parameter has none) flattened into one buffer, summed
    across the ranks by one ``all_reduce`` and divided by the world size;
    each ``.grad`` becomes its view of the result."""
    dtypes = {p.dtype for p in params}
    if len(dtypes) != 1:
        raise ValueError(f"the trainable parameters hold several dtypes {dtypes}; one flat buffer takes one")
    flat = torch.cat([(p.grad if p.grad is not None else torch.zeros_like(p)).reshape(-1) for p in params])
    dist.all_reduce(flat)
    flat.div_(group.world)
    offset = 0
    for p in params:
        p.grad = flat[offset : offset + p.numel()].view_as(p)
        offset += p.numel()


def allreduce_stats(
    loss: torch.Tensor, aux: dict, request: torch.Tensor, group: Group
) -> tuple[torch.Tensor, dict, torch.Tensor]:
    """The step's second and last collective: the loss, every aux value (the
    augmentation's batch means included) and ``request``, each rank's
    requested signal actions, concatenated and averaged across the ranks in
    one ``all_reduce``. Returns them in their shapes and dtypes: the global
    mean loss and aux (the JAX package's ``pmean``), and the mean request,
    above 0 where any rank asked."""
    parts = [loss.detach().reshape(1), *(v.detach().reshape(-1) for v in aux.values()), request.reshape(-1)]
    flat = torch.cat([p.float() for p in parts])
    dist.all_reduce(flat)
    flat.div_(group.world)
    out, offset = [], 0
    for p in parts:
        out.append(flat[offset : offset + p.numel()].to(p.dtype))
        offset += p.numel()
    loss_out = out[0].reshape(loss.shape)
    aux_out = {k: o.reshape(v.shape) for (k, v), o in zip(aux.items(), out[1:-1])}
    return loss_out, aux_out, out[-1].reshape(request.shape)


def gather_to_main(obj: Any, group: Group) -> Optional[list]:
    """Every rank's picklable ``obj`` on rank 0, in rank order (None on the
    other ranks). A collective: every rank calls it at the same point."""
    out = [None] * group.world if group.is_main else None
    dist.gather_object(obj, out, dst=0)
    return out


class RankFailed(RuntimeError):
    """A rank of :func:`spawn` exited with an error or did not finish in time."""


def _rank_main(fn, rank, devices, init_method, backend, timeout, args, results) -> None:
    group = init_group(rank, len(devices), devices[rank], init_method, backend=backend, timeout=timeout)
    try:
        out = fn(group, *args)
    finally:
        dist.destroy_process_group()
    results.put((rank, out))


def spawn(
    fn: Callable[..., Any],
    devices: Sequence,
    *args,
    backend: Optional[str] = None,
    timeout: timedelta = DEFAULT_TIMEOUT,
    join_timeout: Optional[float] = None,
) -> list:
    """Run ``fn(group, *args)`` in one new process per device (the ``spawn``
    start method), rank r on ``devices[r]``, joined in a process group on a
    free localhost port; returns the ranks' return values in rank order.

    ``fn`` and ``args`` are pickled, so ``fn`` is a module-level function.
    Raises :class:`RankFailed` when a rank exits with an error (its
    traceback is on its standard error) or when the ranks have not all
    returned after ``join_timeout`` seconds; the remaining ranks are then
    terminated."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    init_method = free_address()
    procs = [
        ctx.Process(target=_rank_main, args=(fn, rank, list(devices), init_method, backend, timeout, args, results))
        for rank in range(len(devices))
    ]
    for p in procs:
        p.start()
    deadline = None if join_timeout is None else time.monotonic() + join_timeout
    got: dict[int, Any] = {}
    try:
        while len(got) < len(procs):  # drain the queue before joining: a full pipe blocks the writer's exit
            try:
                rank, out = results.get(timeout=0.2)
                got[rank] = out
                continue
            except queue.Empty:
                pass
            if any(p.exitcode not in (None, 0) for p in procs):
                grace = time.monotonic() + 5.0  # for the ranks the failure takes down too
                for p in procs:
                    p.join(timeout=max(0.0, grace - time.monotonic()))
                raise RankFailed("; ".join(f"rank {r} exited with code {p.exitcode}" for r, p in enumerate(procs)
                                           if p.exitcode not in (None, 0)))
            if all(p.exitcode == 0 for p in procs) and results.empty():
                raise RankFailed(f"ranks {sorted(set(range(len(procs))) - set(got))} exited without a result")
            if deadline is not None and time.monotonic() > deadline:
                raise RankFailed(f"the ranks did not finish in {join_timeout} s")
        for p in procs:
            p.join(timeout=60)
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
            if p.is_alive():
                p.kill()
                p.join()
        results.close()
    return [got[r] for r in range(len(procs))]
