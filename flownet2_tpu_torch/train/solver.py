"""The Solver: the train and snapshot loop (flownet2_tpu/train/solver.py;
reference src/caffe/solver.cpp).

- ``make_train_step``: one iteration, with ``iter_size`` accumulation
  (solver.cpp:222-225): gradients summed over the micro-batches and divided
  by ``iter_size``, the loss averaged;
- ``Solver.step`` keeps the loss on the device and synchronizes once every
  ``sync_bound`` steps, so the host never runs unboundedly ahead;
- ``Solver.solve``: display of the loss smoothed over the last
  ``AVERAGE_LOSS`` iterations (solver.cpp's ``average_loss``), a test
  metric every ``test_interval`` (``test_fn(net)``, solver.cpp:327-410),
  snapshots every ``snapshot_interval``, and the SIGINT/SIGHUP actions
  (stop, snapshot) checked once per iteration;
- ``make_multistep_train_step`` and ``Solver.solve_cached``: K steps a
  chunk from the device sample cache (``data.device_cache``), one upload of
  the chunk's indices and coefficients, the single step's math;
- ``loss_schedule``: an Lpq episode schedule (``ops/losses.LpqSchedule``);
  the loss takes the episode of each iteration, and the step is rebuilt
  when it changes (the reference swaps the Lpq exponents at episode
  boundaries, lpq_loss_layer.cu:97-140);
- ``snapshot``/``restore``: the weights as the JAX package's flat ``.npz``
  (``iter_NNNNNNN.npz``, readable by ``flownet2_tpu.checkpoint.load_params``)
  and, beside it, ``iter_NNNNNNN.pt`` with the optimizer state, the
  iteration and any registered host-side state;
- ``group``: data-parallel training, one process per device
  (``parallel``; the JAX package's ``Solver(mesh=...)``): each rank steps
  on its rows of the global batch, the gradients cross the ranks in one
  flat ``all_reduce`` after the last backward and before the update, and
  the loss, aux values and signal requests in one more. Rank 0 logs and
  writes the snapshots; the parameters are broadcast from rank 0 at start,
  after ``copy_weights_from`` and after ``restore``.
"""

from __future__ import annotations

import functools
import os
import signal
import time
from collections import deque
from typing import Any, Callable, Iterator, Optional

import numpy as np
import torch
from torch import nn

from flownet2_tpu_torch.checkpoint import (
    load_params,
    params_from_state_dict,
    save_params,
    state_dict_from_params,
)
from flownet2_tpu_torch.data.pipeline import pack_into, pack_layout, unpack_views
from flownet2_tpu_torch.parallel.data_parallel import allreduce_gradients, allreduce_stats, broadcast_module
from flownet2_tpu_torch.parallel.mesh import Group
from flownet2_tpu_torch.train.solvers import CaffeSolver, SolverConfig, make_solver

AVERAGE_LOSS = 100  # iterations the displayed loss is averaged over
# the signal actions a rank can request, in the order of the request vector
ACTIONS = ("stop", "snapshot")
# aux key of the request vector agreed across the ranks in a group step
REQUEST_KEY = "signal_request"


def make_train_step(
    loss_fn: Callable[[nn.Module, dict], tuple[torch.Tensor, dict]],
    optimizer: CaffeSolver,
    *,
    iter_size: int = 1,
    group: Optional[Group] = None,
) -> Callable[..., tuple[torch.Tensor, dict]]:
    """``step(net, batch) -> (loss, aux)``, both detached and on the device.

    With ``iter_size`` > 1 every tensor of ``batch`` has a leading
    micro-batch axis of that size.

    With a ``group``, ``batch`` holds this rank's rows and the step is
    ``step(net, batch, request) -> (loss, aux)``: after the last backward
    the gradients are averaged across the ranks by one flat ``all_reduce``
    (whatever path ``loss_fn`` takes to the parameters), then the loss, the
    aux values and ``request`` (this rank's signal requests, one float per
    :data:`ACTIONS` entry) by one more; the loss and aux come back as the
    global means, and the agreed requests as ``aux[REQUEST_KEY]``."""
    params = [p for g in optimizer.param_groups for p in g["params"]]

    def step(net, batch, request=None):
        optimizer.zero_grad(set_to_none=True)
        if iter_size == 1:
            loss, aux = loss_fn(net, batch)
            loss.backward()
        else:
            losses, auxes = [], []
            for i in range(iter_size):
                micro_loss, micro_aux = loss_fn(net, {k: v[i] for k, v in batch.items()})
                micro_loss.backward()
                losses.append(micro_loss.detach())
                auxes.append(micro_aux)
            for p in params:
                if p.grad is not None:
                    p.grad.div_(iter_size)
            loss = torch.stack(losses).mean()
            aux = {k: torch.stack([a[k].detach() for a in auxes]).mean(dim=0) for k in auxes[0]}
        if group is not None:
            allreduce_gradients(params, group)
            loss, aux, agreed = allreduce_stats(loss, aux, request, group)
            aux[REQUEST_KEY] = agreed
        optimizer.step()
        return loss.detach(), {k: v.detach() for k, v in aux.items()}

    return step


def upload_bank(bank: dict, device) -> dict:
    """A chunk's bank of host arrays as tensors on ``device``. To a card the
    arrays cross as ONE copy from a pinned buffer (``non_blocking``: the
    host does not wait for it); on the CPU they are the arrays themselves."""
    device = torch.device(device)
    arrays = {k: np.ascontiguousarray(v) for k, v in bank.items()}
    if device.type != "cuda":
        return {k: torch.from_numpy(a) for k, a in arrays.items()}
    offsets, total = pack_layout(arrays)
    host = torch.empty(total, dtype=torch.uint8, pin_memory=True)
    pack_into(host, arrays, offsets)
    return unpack_views(host.to(device, non_blocking=True), arrays, offsets)


def make_multistep_train_step(
    loss_fn: Callable[[nn.Module, dict], tuple[torch.Tensor, dict]],
    optimizer: CaffeSolver,
) -> Callable[[nn.Module, tuple, dict], torch.Tensor]:
    """K train steps from one bank: ``run(net, slabs, bank) -> losses[K]``,
    a device vector, for the device cache (``data.device_cache.CacheChunks``).

    ``slabs``: the cache's slab dicts; ``bank``: host arrays with leading
    axis K, ``cache_idx`` (K, batch) indices into the slabs' concatenation
    in slab order and the per-step ``aug_*`` coefficients. The
    concatenation is made once a chunk, the bank crosses to the device in
    one copy (:func:`upload_bank`), and step i is :func:`make_train_step`'s
    step on row i: ``loss_fn`` (a ``make_cache_gather_loss`` objective) sees
    the batch the single-step path sees, so the math is that path's. Nothing
    here waits for the device; the per-step aux values are dropped."""
    inner = make_train_step(loss_fn, optimizer)

    def run(net, slabs, bank) -> torch.Tensor:
        first = slabs[0]
        merged = {
            f"cache_{k}": torch.cat([s[k] for s in slabs]) if len(slabs) > 1 else first[k] for k in first
        }
        rows = upload_bank(bank, next(iter(first.values())).device)
        losses = []
        for i in range(rows["cache_idx"].shape[0]):
            loss, _ = inner(net, {**merged, **{k: v[i] for k, v in rows.items()}})
            losses.append(loss)
        return torch.stack(losses)

    return run


class Solver:
    """Owns the net, its optimizer and the iteration, and drives the loop
    (reference Solver::Solve).

    ``net`` is moved to ``device``; the optimizer updates the parameters of
    ``trainable`` (a sub-module of ``net``; default the whole net), and every
    other parameter of ``net`` is frozen (``requires_grad`` off).

    ``loss_schedule``: an object with ``.at(iteration) -> episode`` (an
    ``LpqSchedule``); each step then calls ``loss_fn(net, batch,
    episode=...)`` with the episode of the iteration it runs.

    ``test_fn(net) -> float``: every ``test_interval`` iterations
    :meth:`solve` logs ``Iteration N, test metric = x`` (e.g. a held-out
    EPE, as ``cli/test.py`` scores it) through :meth:`test`, which a loop
    of its own over :meth:`step` calls too (``tools/overfit.py``).

    ``group``: this process's rank of a data-parallel group
    (``parallel.mesh.Group``); ``device`` defaults to its device, and
    :meth:`step` takes this rank's rows of each global batch
    (``parallel.rank_rows``). A signal seen by any rank acts on every rank
    at the same iteration: the requests ride the step's stats collective,
    and each step acts on the requests agreed one step before, so that
    reading them waits for that step alone and the host stays a step
    ahead of the device."""

    def __init__(
        self,
        config: SolverConfig,
        loss_fn: Callable,
        net: nn.Module,
        *,
        device=None,
        trainable: Optional[nn.Module] = None,
        snapshot_dir: Optional[str] = None,
        snapshot_interval: int = 0,
        display: int = 100,
        loss_schedule: Optional[Any] = None,
        test_fn: Optional[Callable[[nn.Module], float]] = None,
        test_interval: int = 0,
        group: Optional[Group] = None,
    ):
        if device is None and group is None:
            raise ValueError("Solver needs a device or a group")
        self.config = config
        self.group = group
        self.device = torch.device(device) if device is not None else group.device
        if group is not None and self.device != group.device:
            raise ValueError(f"device {self.device} is not the group's {group.device}")
        self.net = net.to(self.device)
        if group is not None:
            broadcast_module(self.net, group)
        params = list((net if trainable is None else trainable).parameters())
        train_ids = {id(p) for p in params}
        for p in net.parameters():
            p.requires_grad_(id(p) in train_ids)
        self.optimizer = make_solver(config, params)
        self._loss_fn = loss_fn
        self._loss_schedule = loss_schedule
        self._episode = loss_schedule.at(0) if loss_schedule is not None else None
        self.step_fn = self._build_step(self._episode)
        self.iteration = 0
        self.snapshot_dir = snapshot_dir
        self.snapshot_interval = snapshot_interval
        self.display = display
        self.test_fn = test_fn
        self.test_interval = test_interval
        self._loss_window: deque = deque(maxlen=AVERAGE_LOSS)
        self._requested_action = None
        self._agreed = None  # in a group: the requests agreed at the previous step, on their way to the host
        self._agreed_before: Optional[list] = None
        # one host sync per sync_bound steps bounds how far the host runs ahead
        self.sync_bound = 64
        self._steps_since_sync = 0
        self.history: list[tuple[int, float]] = []
        # host-side state saved with snapshots: objects with
        # state_dict() / load_state_dict() of numpy arrays
        self._extras: dict[str, Any] = {}

    def _build_step(self, episode):
        loss_fn = self._loss_fn if episode is None else functools.partial(self._loss_fn, episode=episode)
        return make_train_step(loss_fn, self.optimizer, iter_size=self.config.iter_size, group=self.group)

    def register_extra(self, name: str, obj: Any) -> None:
        """Register host-side state to persist alongside snapshots."""
        self._extras[name] = obj

    def install_signal_handlers(self) -> None:
        """Reference SignalHandler defaults: SIGINT stops, SIGHUP snapshots."""

        def handler_factory(action):
            def handler(signum, frame):
                self._requested_action = action

            return handler

        signal.signal(signal.SIGINT, handler_factory("stop"))
        if hasattr(signal, "SIGHUP"):
            signal.signal(signal.SIGHUP, handler_factory("snapshot"))

    @property
    def smoothed_loss(self) -> float:
        """Mean loss over the last ``AVERAGE_LOSS`` steps (a host sync)."""
        if not self._loss_window:
            return float("nan")
        return float(torch.stack(list(self._loss_window)).mean())

    def step(self, batch: dict) -> tuple[torch.Tensor, dict]:
        """One training iteration on a batch of arrays or tensors. Returns the
        loss as a device tensor: nothing here waits for the device, except
        one sync every ``sync_bound`` steps."""
        if self._loss_schedule is not None:
            episode = self._loss_schedule.at(self.iteration)
            if episode != self._episode:
                self._episode = episode
                self.step_fn = self._build_step(episode)
        batch = {k: torch.as_tensor(v).to(self.device, non_blocking=True) for k, v in batch.items()}
        if self.group is None:
            loss, aux = self.step_fn(self.net, batch)
        else:
            request = torch.zeros(len(ACTIONS), device=self.device)
            if self._requested_action is not None:
                request[ACTIONS.index(self._requested_action)] = 1.0
                self._requested_action = None
            loss, aux = self.step_fn(self.net, batch, request)
            agreed, self._agreed = self._agreed, _HostCopy(aux.pop(REQUEST_KEY))
            self._agreed_before = agreed.read() if agreed is not None else None
        self.iteration += 1
        self._loss_window.append(loss)
        self._steps_since_sync += 1
        if self._steps_since_sync >= self.sync_bound:
            self._steps_since_sync = 0
            float(loss)
        return loss, aux

    @property
    def is_main(self) -> bool:
        """Whether this process logs and writes snapshots: rank 0, or the
        only process."""
        return self.group is None or self.group.is_main

    def _take_action(self) -> Optional[str]:
        """The signal action to carry out after this step: this process's
        request, or in a group the first of :data:`ACTIONS` that a rank
        requested, as agreed at the previous step."""
        if self.group is None:
            action = self._requested_action
            if action == "snapshot":
                self._requested_action = None
            return action
        agreed, self._agreed_before = self._agreed_before, None
        return next((a for a, v in zip(ACTIONS, agreed or ()) if v > 0), None)

    def test(self, log: Callable[[str], None] = print) -> float:
        """Score the net with ``test_fn`` and log ``Iteration N, test
        metric = x``, the line tools/parse_log.py reads."""
        metric = self.test_fn(self.net)
        log(f"Iteration {self.iteration}, test metric = {metric:.6f}")
        return metric

    def solve(
        self,
        data_iter: Iterator,
        *,
        max_iter: Optional[int] = None,
        log: Callable[[str], None] = print,
        batch_hook: Optional[Callable[[Any], Any]] = None,
        on_step: Optional[Callable[[int, torch.Tensor, dict], None]] = None,
    ) -> None:
        """Train until ``max_iter``, honouring the display and snapshot
        intervals and the signal actions. ``batch_hook(batch) -> batch`` runs
        on each batch just before its step (at step time, unlike a loader
        transform, which runs batches ahead); ``on_step(iteration, loss,
        aux)`` runs after each step, for host state that mirrors the step
        (a ``data.mean.MeanRecompute``). In a group only rank 0 logs and
        writes snapshots."""
        max_iter = self.config.max_iter if max_iter is None else max_iter
        if not self.is_main:
            log = _silent
        t0 = time.time()
        while self.iteration < max_iter:
            batch = next(data_iter)
            if batch_hook is not None:
                batch = batch_hook(batch)
            loss, aux = self.step(batch)
            if on_step is not None:
                on_step(self.iteration, loss, aux)
            it = self.iteration
            if self.display and it % self.display == 0:
                rate = self.display / max(time.time() - t0, 1e-9)
                t0 = time.time()
                log(f"Iteration {it}, loss = {self.smoothed_loss:.6f} ({rate:.2f} iter/s)")
                self.history.append((it, self.smoothed_loss))
            if self.test_fn and self.test_interval and it % self.test_interval == 0 and self.is_main:
                self.test(log)
            if self.snapshot_interval and self.snapshot_dir and it % self.snapshot_interval == 0:
                self.snapshot()
            action = self._take_action()
            if action == "stop":
                log(f"Stopping early at iteration {it} (signal).")
                break
            if action == "snapshot":
                self.snapshot()
        if self.snapshot_dir:
            self.snapshot()

    def solve_cached(
        self,
        chunk_iter: Iterator,
        *,
        max_iter: Optional[int] = None,
        log: Callable[[str], None] = print,
    ) -> None:
        """The device-cache loop: ``chunk_iter`` yields ``(slabs, bank)``
        chunks (``data.device_cache.CacheChunks``), each of K iterations run
        by :func:`make_multistep_train_step`. The math is :meth:`solve`'s;
        all K losses enter the smoothed window, the host syncs once every
        ``sync_bound`` iterations, and the display, test and snapshot
        intervals and the signal actions are honoured at chunk boundaries
        (at the first boundary at or past each interval). A last chunk that
        would pass ``max_iter`` is cut to it.

        Refused: a loss schedule (its episodes would quantize to the
        chunk), ``iter_size`` above 1 (the chunk's steps take one
        micro-batch each) and a data-parallel ``group`` (the cache holds
        one device's samples)."""
        if self._loss_schedule is not None:
            raise ValueError("solve_cached does not support loss schedules (episode boundaries would quantize "
                             "to the dispatch size); use solve()")
        if self.group is not None:
            raise ValueError("solve_cached is single-device (the device cache feeds one process)")
        if self.config.iter_size != 1:
            raise ValueError("solve_cached runs one micro-batch a step; iter_size > 1 would change the effective "
                             "batch and the gradient scale: use solve()")
        run = make_multistep_train_step(self._loss_fn, self.optimizer)
        max_iter = self.config.max_iter if max_iter is None else max_iter
        t0, disp_iter = time.time(), self.iteration
        while self.iteration < max_iter:
            slabs, bank = next(chunk_iter)
            k = int(bank["cache_idx"].shape[0])
            if k > max_iter - self.iteration:  # the last, partial chunk
                k = max_iter - self.iteration
                bank = {n: v[:k] for n, v in bank.items()}
            losses = run(self.net, tuple(slabs), bank)
            self.iteration += k
            self._loss_window.extend(losses.unbind())
            self._steps_since_sync += k
            if self._steps_since_sync >= self.sync_bound:
                self._steps_since_sync = 0
                float(losses[-1])
            it = self.iteration
            if _crossed(it, k, self.display):
                rate = (it - disp_iter) / max(time.time() - t0, 1e-9)
                t0, disp_iter = time.time(), it
                log(f"Iteration {it}, loss = {self.smoothed_loss:.6f} ({rate:.2f} iter/s)")
                self.history.append((it, self.smoothed_loss))
            if self.test_fn and _crossed(it, k, self.test_interval):
                self.test(log)
            if self.snapshot_dir and _crossed(it, k, self.snapshot_interval):
                self.snapshot()
            action = self._take_action()
            if action == "stop":
                log(f"Stopping early at iteration {it} (signal).")
                break
            if action == "snapshot":
                self.snapshot()
        if self.snapshot_dir:
            self.snapshot()

    # -- checkpointing (reference Snapshot/Restore, solver.cpp:412-483)
    def snapshot(self) -> str:
        """Write ``iter_NNNNNNN.npz`` and ``.pt``; return their common prefix.
        In a group rank 0 writes them, and the other ranks only return the
        prefix: every rank holds the same state."""
        prefix = os.path.abspath(os.path.join(self.snapshot_dir, f"iter_{self.iteration:07d}"))
        if not self.is_main:
            return prefix
        os.makedirs(self.snapshot_dir, exist_ok=True)
        save_params(prefix + ".npz", params_from_state_dict(self.net.state_dict()))
        extras = {
            name: {k: torch.as_tensor(np.asarray(v)) for k, v in obj.state_dict().items()}
            for name, obj in self._extras.items()
        }
        torch.save(
            {"iteration": self.iteration, "optimizer": self.optimizer.state_dict(), "extras": extras},
            prefix + ".pt",
        )
        return prefix

    def restore(self, path: str) -> None:
        """Resume from a snapshot, named by its prefix or either file. In a
        group every rank reads it, and the parameters are then broadcast
        from rank 0."""
        prefix = path[: -len(os.path.splitext(path)[1])] if path.endswith((".npz", ".pt")) else path
        self.net.load_state_dict(state_dict_from_params(load_params(prefix + ".npz")), strict=True)
        state = torch.load(prefix + ".pt", map_location=self.device, weights_only=True)
        self.optimizer.load_state_dict(state["optimizer"])
        self.iteration = int(state["iteration"])
        for name, obj in self._extras.items():
            if state["extras"].get(name):
                obj.load_state_dict({k: v.cpu().numpy() for k, v in state["extras"][name].items()})
        if self.group is not None:
            broadcast_module(self.net, self.group)

    def copy_weights_from(self, params: dict, strict: bool = False) -> None:
        """Finetuning as ``caffe train -weights``: copy the JAX-layout
        ``params`` whose names AND shapes match; leave the rest
        (net.cpp:752-804). ``strict`` raises on any mismatch instead."""
        src = state_dict_from_params(params)
        with torch.no_grad():
            for key, dst in self.net.state_dict().items():
                if key in src and src[key].shape == dst.shape:
                    dst.copy_(src[key])
                elif strict:
                    got = tuple(src[key].shape) if key in src else "missing"
                    raise ValueError(f"parameter {key}: {got} vs {tuple(dst.shape)}")
        if self.group is not None:
            broadcast_module(self.net, self.group)


def _crossed(it: int, k: int, interval: int) -> bool:
    """Whether the chunk of ``k`` iterations ending at ``it`` crossed a
    multiple of ``interval`` (0: never)."""
    return bool(interval) and it // interval > (it - k) // interval


def _silent(_: str) -> None:
    """The log of the ranks other than 0."""


class _HostCopy:
    """A small device tensor on its way to the host: the copy is queued
    behind the work that makes the tensor, and :meth:`read` waits for that
    work alone, not for what was queued after it."""

    def __init__(self, t: torch.Tensor):
        if t.is_cuda:
            self.host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self.host.copy_(t, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.host, self.event = t, None

    def read(self) -> list:
        if self.event is not None:
            self.event.synchronize()
        return self.host.tolist()
