"""train on PyTorch: the ``caffe train`` brew command (tools/caffe.cpp:154-226).

Flag-compatible with flownet2_tpu/cli/train.py where the port has the piece:

    python -m flownet2_tpu_torch.cli.train --model flownetc --dataset flyingchairs
        --data-root DIR [--no-augment] [--recompute-mean K] [--mean-per-pixel]
        [--write-augmented DIR] [--loss KEY] [--schedule S_long] [--base-lr LR]
        [--solver adam] [--batch 8] [--crop 320x448] [--iter-size 1] [--max-iter N]
        [--weights W] [--snapshot DIR/iter_NNNNNNN] [--snapshot-dir DIR]
        [--snapshot-interval N] [--display N] [--seed S] [--device-cache N [--cache-slab 64]
        [--steps-per-dispatch K]] [--gpu N|all|i,j | --device cpu]

- augmentation is on by default, as the paper trains: the loader hands
  over batches at source resolution with the sampled coefficients, and the
  card makes the crops (the affine sample on the warp kernel K1), the
  ground-truth flow transform, the chromatic transform and the noise
  (``data/augment_pipeline.py``); ``--no-augment`` trains on center crops.
  ``--recompute-mean K`` subtracts a running mean of the augmented images,
  updated for K iterations (per channel, or per pixel with
  ``--mean-per-pixel``), and snapshots it; ``--write-augmented DIR`` writes
  the augmented batch, its coefficients and the mean files every display
  interval;
- ``--dataset``: a layout (flyingchairs, chairssdhom, flyingthings3d,
  sintel, kitti) or a packed format (flowrec, lmdb, leveldb, or auto to
  sniff one) at ``--data-root``. ``.flowrec`` records are read in transport
  mode (uint8 images, int16 flow, decoded on the card by the objective);
- ``--model dispnetc`` trains on disparity: a disparity ``.flowrec``, or a
  disparity LMDB / LevelDB (the reference's 3+3+1-channel packing);
- ``--loss`` picks an objective of ``train.objectives.LOSSES`` (default: the
  model's own); the cascade-stage losses (flownet2-s1, -s2, -fusion,
  -c-stage, -sd-stage) train one sub-net of ``--model flownet2``;
  flownet2-sd-sdhom (the ChairsSDHom recipe's Lpq loss, at its first
  episode (2.0, 0.5): no loss schedule, no black augmentation) trains
  ``--model flownet2-sd``;
- ``--weights`` copies the layers whose names and shapes match from a flat
  ``.npz`` or the reference's ``.caffemodel`` / ``.caffemodel.h5`` (whose
  import must fit the model's net); ``--snapshot`` resumes weights,
  optimizer state and iteration;
- ``--gpu N`` trains on ``cuda:N``; ``--device`` names a device instead
  (``cpu`` for tests). Without a card and without ``--device`` the CLI
  exits with an error: it never falls back to the CPU;
- ``--gpu all`` or a list ``i,j`` trains data-parallel, one process per
  card over NCCL (``parallel``): ``--batch`` is per card, so the global
  batch is ``--batch`` x cards (the reference's ``caffe train -gpu 0,1``,
  docs/multigpu.md:11). The loader is keyed: each rank decodes and
  augments its rows of global batch k, whichever thread makes it. The
  gradients cross the cards in one flat all-reduce a step; rank 0 logs,
  writes snapshots and, with ``--write-augmented``, the global batch,
  gathered at display steps. One picked card trains in this process. A
  card asked for and not present, or a duplicate, exits with an error,
  and so does the whole run when a rank fails;
- ``--device-cache N`` trains from the device sample cache
  (``data/device_cache.py``): N samples (rounded up to whole slabs of
  ``--cache-slab``, at least 2 slabs) held on the card in the transport
  domain, refreshed from the dataset by a background thread, each batch
  gathered on the card by index and augmented there (with
  ``--no-augment`` the samples are center-cropped before caching).
  ``--steps-per-dispatch K`` runs K iterations from one bank of indices and
  coefficients uploaded in one copy (``Solver.solve_cached``; display,
  test and snapshots at chunk boundaries); 0 means 32 with the cache, else
  1. The run ends with ``Device cache: S slab refreshes, N samples
  uploaded (M MB)``;
- without the cache the loader's batches reach the card through
  ``data.pipeline.DevicePrefetcher``: a thread packs each batch into pinned
  memory and copies it on a stream of its own, so a step never waits for
  its upload (each rank of a group stages its own rows to its own card).

Refused with a message: ``--device-cache`` with several cards (the cache
feeds one), with ``--write-augmented``, with ``--iter-size`` above 1, and
with ``--recompute-mean`` at K above 1 (the running mean needs each step's
aux values), as in the JAX CLI; ``--steps-per-dispatch`` above 1 without
``--device-cache`` (the JAX CLI ignores it); ``--model dispnetc`` without
``--no-augment`` (the augmentation transforms 2-channel flow, not
1-channel disparity; so does the JAX package's); and ``--recompute-mean``
with ``--iter-size`` above 1.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Callable, Optional

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--model", default="flownets", help="flownets|flownetc|flownet2-sd|flownet2")
    p.add_argument("--loss", default=None, help="objective (train.objectives.LOSSES); default: the model's")
    p.add_argument("--dataset", default="flyingchairs",
                   help="flyingchairs|chairssdhom|flyingthings3d|sintel|kitti|flowrec|lmdb|leveldb|auto")
    p.add_argument("--data-root", required=True)
    p.add_argument("--schedule", default="S_long", help="S_long|S_short|S_fine")
    p.add_argument("--base-lr", type=float, default=None, help="override the schedule's base_lr")
    p.add_argument("--solver", default="adam", help="sgd|nesterov|adagrad|rmsprop|adadelta|adam")
    p.add_argument("--batch", type=int, default=8, help="batch per card: the global batch is --batch x cards")
    p.add_argument("--crop", default="320x448", help="HxW training crop")
    p.add_argument("--iter-size", type=int, default=1, help="micro-batches accumulated per iteration")
    p.add_argument("--max-iter", type=int, default=0, help="0: the schedule's")
    p.add_argument("--weights", default=None, help="finetune from a flat .npz, .caffemodel or .caffemodel.h5")
    p.add_argument("--snapshot", default=None, help="resume from a snapshot (DIR/iter_NNNNNNN)")
    p.add_argument("--snapshot-dir", default="snapshots")
    p.add_argument("--snapshot-interval", type=int, default=50000)
    p.add_argument("--display", type=int, default=100)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--no-augment", action="store_true", help="train on center crops, without augmentation")
    p.add_argument("--recompute-mean", type=int, default=0, metavar="K",
                   help="running-mean window: update a mean of the augmented images for K iterations and "
                   "subtract it every step (AugmentationParameter.recompute_mean)")
    p.add_argument("--mean-per-pixel", action="store_true",
                   help="subtract the per-pixel mean instead of its per-channel average")
    p.add_argument("--write-augmented", default=None, metavar="DIR",
                   help="debug: write the augmented batch, its coefficients and the mean files to DIR every "
                   "display interval (AugmentationParameter.write_augmented)")
    p.add_argument("--gpu", default="0", help="CUDA card index, 'all', or a comma list of indices: one process a card")
    p.add_argument("--device", default=None, help="explicit torch device (e.g. 'cpu'); overrides --gpu")
    p.add_argument("--device-cache", type=int, default=0, metavar="N",
                   help="hold a rolling cache of N samples on the card, refreshed from the dataset in the "
                   "background, and gather each batch from it there (data/device_cache.py); one card")
    p.add_argument("--cache-slab", type=int, default=64, metavar="K",
                   help="samples a cache slab (the refresh's unit; --device-cache rounds up to whole slabs)")
    p.add_argument("--steps-per-dispatch", type=int, default=0, metavar="K",
                   help="with --device-cache: K iterations from one uploaded bank of indices and coefficients "
                   "(Solver.solve_cached); display and snapshots at chunk boundaries. 0: 32 with the cache, else 1")
    return p


def _steps_per_dispatch(args) -> int:
    return args.steps_per_dispatch or (32 if args.device_cache else 1)


def _refuse_unsupported(args) -> None:
    steps = _steps_per_dispatch(args)
    if steps > 1 and not args.device_cache:
        raise SystemExit("--steps-per-dispatch above 1 runs chunks from the device cache; pass --device-cache")
    if args.device_cache:
        if args.write_augmented:
            raise SystemExit("--device-cache does not support --write-augmented")
        if args.iter_size > 1:
            raise SystemExit("--device-cache draws one batch a step; it does not take --iter-size above 1")
        if steps > 1 and args.recompute_mean:
            raise SystemExit("--recompute-mean needs each step's aux values; use --steps-per-dispatch 1")
    if args.model == "dispnetc" and not args.no_augment:
        raise SystemExit("--model dispnetc trains on 1-channel disparity, which the augmentation cannot transform: "
                         "its ground-truth transform takes 2-channel flow, in the JAX package too; pass --no-augment")
    if args.recompute_mean and args.iter_size > 1 and not args.no_augment:
        raise SystemExit("--recompute-mean updates its mean once a step from the whole batch; "
                         "it does not take --iter-size above 1")


def _open_dataset(args):
    """The training set, its items checked to carry what the model learns:
    1-channel disparity for DispNetC, 2-channel flow for the flow nets."""
    from flownet2_tpu_torch.data import FlowRecordReader, open_dataset
    from flownet2_tpu_torch.data.datasets import PACKED_FORMATS
    from flownet2_tpu_torch.data.lmdb import DISPARITY_ENCODINGS, DISPARITY_SLICE_POINTS

    key = args.dataset.lower().replace("_", "")
    stereo = args.model == "dispnetc"
    if stereo and key not in PACKED_FORMATS + ("auto",):
        raise SystemExit(f"--model dispnetc trains on disparity, which the {args.dataset} layout does not hold; "
                         "pack it as a disparity .flowrec (cli.convert_dataset) or pass a disparity LMDB or LevelDB")
    kw = {}
    if stereo and key in ("lmdb", "leveldb"):
        kw = dict(slice_points=DISPARITY_SLICE_POINTS, encodings=DISPARITY_ENCODINGS)
    dataset = open_dataset(args.dataset, args.data_root, **kw)
    if isinstance(dataset, FlowRecordReader):
        dataset.transport = True  # uint8 / int16 to the card, decoded there
    channels = dataset[0]["flow"].shape[-1]
    if channels != (1 if stereo else 2):
        raise SystemExit(f"{args.data_root}: items carry {channels}-channel ground truth; --model {args.model} "
                         f"trains on {'1-channel disparity' if stereo else '2-channel flow'}")
    return dataset


def _loss_key(args) -> str:
    """The objective's key in ``LOSSES``, checked to train ``--model``."""
    from flownet2_tpu_torch.models import NETS, FlowNet2
    from flownet2_tpu_torch.train.objectives import LOSS_MODEL, LOSSES, STAGE_LOSS_KEY

    if args.model not in NETS:
        raise SystemExit(f"unknown model {args.model!r}; choose from {sorted(NETS)}")
    loss_key = args.loss or args.model
    if loss_key not in LOSSES:
        raise SystemExit(f"no training objective {loss_key!r}; choose from {sorted(LOSSES)}")
    stage_loss = loss_key in STAGE_LOSS_KEY.values()
    if stage_loss != (NETS[args.model] is FlowNet2) or (
        not stage_loss and LOSS_MODEL.get(loss_key, loss_key) != args.model
    ):
        raise SystemExit(f"objective {loss_key!r} does not train model {args.model!r}: the cascade-stage "
                         "objectives take --model flownet2, the others their own model")
    return loss_key


def _devices(args) -> list[str]:
    """The devices to train on: ``--device``, or the cards of ``--gpu``."""
    if args.device is not None:
        return [args.device]
    from flownet2_tpu_torch.parallel import pick_devices

    try:
        return [str(d) for d in pick_devices(args.gpu)]
    except ValueError as e:
        raise SystemExit(str(e)) from None


def main(
    argv=None,
    *,
    cache_options: Optional[dict] = None,
    sample_dtype=None,
    net_hook: Optional[Callable] = None,
) -> int:
    """The CLI. For scripts, beyond the flags (no flag sets them), on one
    device: ``cache_options``, keyword arguments for the device cache's
    constructor (its throttles ``min_echo`` and ``link_duty``);
    ``sample_dtype``, the augmentation's affine sample dtype
    (``make_augmented_loss``; None is its float32 default); ``net_hook``,
    called with the net once its weights are in, before training (a
    diagnostic arm such as ``tools/diag/tpu_arith.route_convs``)."""
    args = build_parser().parse_args(argv)
    _refuse_unsupported(args)
    _loss_key(args)
    devices = _devices(args)
    if args.device_cache and len(devices) > 1:
        raise SystemExit("--device-cache is single-device: the cache feeds one card")
    if len(devices) == 1:
        return train(args, devices[0], cache_options=cache_options, sample_dtype=sample_dtype, net_hook=net_hook)
    if sample_dtype is not None or net_hook is not None:
        raise SystemExit("sample_dtype and net_hook are single-device")
    return train_ranks(args, devices)


def train_ranks(args, devices: list[str]) -> int:
    """Train on ``devices``, one process each (``parallel.spawn``), and
    return 0, or 1 when a rank failed. The kernels are built here first, so
    that the ranks only load them. The ranks join over NCCL on cards and
    over gloo on the CPU (tests run ``["cpu", "cpu"]``). SIGINT and SIGHUP
    are left to the ranks, which agree on their action."""
    import signal

    import torch

    from flownet2_tpu_torch.parallel import RankFailed, spawn

    if torch.device(devices[0]).type == "cuda":
        from flownet2_tpu_torch._build import build

        build()
    ignored = [s for s in (signal.SIGINT, getattr(signal, "SIGHUP", None)) if s is not None]
    saved = [signal.signal(s, signal.SIG_IGN) for s in ignored]
    try:
        spawn(_train_rank, devices, args)
    except RankFailed as e:
        print(f"train: {e}", file=sys.stderr)
        return 1
    finally:
        for s, handler in zip(ignored, saved):
            signal.signal(s, handler)
    return 0


def _train_rank(group, args) -> int:
    return train(args, group.device, group=group)


def train(args, device, *, group=None, cache_options: Optional[dict] = None, sample_dtype=None,
          net_hook: Optional[Callable] = None) -> int:
    """The training run on ``device``: alone, or as this process's rank of
    a data-parallel ``group`` (``parallel.mesh.Group``). ``sample_dtype``
    and ``net_hook``: as in :func:`main`."""
    from flownet2_tpu_torch.checkpoint import init_params, load_into
    from flownet2_tpu_torch.cli.run_flownet import load_weights
    from flownet2_tpu_torch.data import BatchLoader, DevicePrefetcher
    from flownet2_tpu_torch.data.augment_pipeline import (
        BATCH_MEAN_KEYS,
        MEAN_KEYS,
        make_augmented_loss,
        make_flownet_augmenter,
        write_augmented,
    )
    from flownet2_tpu_torch.data.mean import MeanRecompute
    from flownet2_tpu_torch.models import NETS
    from flownet2_tpu_torch.parallel import gather_to_main
    from flownet2_tpu_torch.train import FLOWNET_SCHEDULES, Solver, SolverConfig
    from flownet2_tpu_torch.train.objectives import LOSSES, trainable_module

    import torch

    loss_key = _loss_key(args)
    crop_h, crop_w = (int(v) for v in args.crop.split("x"))
    rank, world = (group.rank, group.world) if group is not None else (0, 1)
    log = print if rank == 0 else (lambda *_: None)
    dataset = _open_dataset(args)

    sched = dict(FLOWNET_SCHEDULES[args.schedule])
    max_iter = args.max_iter or sched["max_iter"]
    config = SolverConfig(
        solver_type=args.solver,
        lr_policy=sched["policy"],
        base_lr=sched["base_lr"] if args.base_lr is None else args.base_lr,
        gamma=sched.get("gamma", 0.1),
        stepvalues=sched.get("stepvalues", ()),
        max_iter=max_iter,
        momentum=0.9,
        momentum2=0.999,
        iter_size=args.iter_size,
    )
    augment = not args.no_augment
    loss_fn, means, transform = LOSSES[loss_key], [], None
    if augment:
        loss_fn = make_augmented_loss(loss_fn, crop_h, crop_w, seed=args.seed, mean_window=args.recompute_mean,
                                      mean_per_pixel=args.mean_per_pixel, rank=rank,
                                      sample_dtype=sample_dtype or torch.float32)
        transform = make_flownet_augmenter(crop_h, crop_w)
        if args.recompute_mean > 0:
            means = [MeanRecompute(crop_h, crop_w, 3, window=args.recompute_mean, per_pixel=args.mean_per_pixel)
                     for _ in MEAN_KEYS]
    if args.device_cache:
        from flownet2_tpu_torch.data.device_cache import make_cache_gather_loss

        loss_fn = make_cache_gather_loss(loss_fn)  # gather, then decode and augment
    with torch.device("meta"):
        net = NETS[args.model]()
    load_into(net, init_params(args.model, seed=args.seed))
    if net_hook is not None:
        net_hook(net)
    solver = Solver(
        config, loss_fn, net, device=device, trainable=trainable_module(net, loss_key),
        snapshot_dir=args.snapshot_dir, snapshot_interval=args.snapshot_interval, display=args.display, group=group,
    )
    solver.install_signal_handlers()
    for i, m in enumerate(means):
        solver.register_extra(f"mean{i}", m)
    if args.weights:
        solver.copy_weights_from(load_weights(args.weights, args.model))
    if args.snapshot:
        solver.restore(args.snapshot)

    # with augmentation the batches stay at source resolution: the card
    # crops. In a group the loader is keyed and this rank's rows of each
    # global batch come out.
    cache, steps = None, _steps_per_dispatch(args)
    if args.device_cache:
        cache, loader = _cache_loader(args, dataset, device, crop_h, crop_w, steps, cache_options or {})
    else:
        loader = BatchLoader(dataset, args.batch * args.iter_size * world, crop=None if augment else (crop_h, crop_w),
                             shuffle_seed=args.seed, transform=transform,
                             shard=(rank, world) if group is not None else None)
    last_batch = {}  # the batch of the latest step, for --write-augmented

    # The running mean attaches at step time, not in the prefetching
    # transform: a transform runs batches ahead, and would hand the card a
    # mean and a counter that lag the host mirror by the queue's depth (the
    # reference updates its mean blobs inside Forward, cu:592-635).
    def batch_hook(batch):
        if augment and args.write_augmented:
            last_batch["batch"] = batch
        for m, key in zip(means, MEAN_KEYS):
            batch = m.attach(batch, key=key)
        if args.iter_size > 1:  # the leading micro-batch axis make_train_step takes
            batch = {k: v.reshape(args.iter_size, args.batch, *v.shape[1:]) for k, v in batch.items()}
        return batch

    def on_step(it, loss, aux):
        for m, key in zip(means, BATCH_MEAN_KEYS):
            m.update(aux[key].cpu().numpy())
        if last_batch and args.display and it % args.display == 0:
            batch = {k: v.cpu().numpy() for k, v in last_batch["batch"].items()}
            if group is not None:  # the global batch, on rank 0
                parts = gather_to_main(batch, group)
                if parts is None:
                    return
                batch = {k: np.concatenate([part[k] for part in parts]) for k in batch}
            write_augmented(batch, args.write_augmented, it, crop_h, crop_w, device=device)
            for i, m in enumerate(means):
                m.write_mean(os.path.join(args.write_augmented, f"mean{i}.float3"))

    batch_text = f"batch {args.batch}" if group is None else (
        f"batch {args.batch * world} ({args.batch} x {world} devices)")
    where = device if group is None else f"{world} processes ({group.backend}), rank 0 on {device}"
    log(f"Training {args.model} ({loss_key}) on {args.dataset} ({len(dataset)} samples) on {where}, "
        f"{max_iter} iterations, crop {crop_h}x{crop_w}, {batch_text} x iter_size {args.iter_size}"
        + (", augmented" if augment else ", center crops")
        + (f", device cache {cache.stats()['capacity_samples']} samples, {steps} steps a dispatch" if cache else ""))
    # the loader's batches are staged on the card ahead of their steps
    batches = iter(loader) if cache is not None else iter(DevicePrefetcher(iter(loader), device=solver.device))
    try:
        if cache is not None and steps > 1:
            solver.solve_cached(batches, max_iter=max_iter)
        else:
            solver.solve(batches, max_iter=max_iter, batch_hook=batch_hook, on_step=on_step)
    finally:
        if cache is not None:
            cache.stop()
        else:
            batches.close()  # stops the staging thread
    if cache is not None:
        st = cache.stats()
        log(f"Device cache: {st['slabs_swapped']} slab refreshes, {st['samples_uploaded']} samples uploaded "
            f"({st['bytes_uploaded'] / 1e6:.0f} MB)")
    log(f"Optimization done, final smoothed loss {solver.smoothed_loss:.4f}")
    return 0


def _cache_loader(args, dataset, device, crop_h: int, crop_w: int, steps: int, options: dict):
    """(the device cache on ``device``, its iterator of batches at one step
    a dispatch, else of (slabs, bank) chunks of ``steps`` steps)."""
    from flownet2_tpu_torch.data.augment_pipeline import FlowNetAugConfig, sample_aug_arrays
    from flownet2_tpu_torch.data.device_cache import CacheBatches, CacheChunks, DeviceSampleCache, cycle_dataset
    from flownet2_tpu_torch.data.pipeline import center_crop

    samples = cycle_dataset(dataset, seed=args.seed)
    if args.no_augment:  # the augmented path crops on the card
        samples = ({k: center_crop(v, (crop_h, crop_w)) for k, v in s.items()} for s in samples)
        src_h, src_w = crop_h, crop_w
    else:
        src_h, src_w = dataset[0]["img0"].shape[:2]
    n_slabs = max(2, -(-args.device_cache // args.cache_slab))
    cache = DeviceSampleCache(samples, slab_samples=args.cache_slab, n_slabs=n_slabs, device=device, **options)
    aug_sampler = None
    if not args.no_augment:
        config = FlowNetAugConfig()

        def aug_sampler(rng, n):
            return sample_aug_arrays(config, rng, n, src_h, src_w, crop_h, crop_w)

    if steps > 1:
        return cache, CacheChunks(cache, args.batch, steps, seed=args.seed, aug_sampler=aug_sampler)
    return cache, CacheBatches(cache, args.batch, seed=args.seed, aug_sampler=aug_sampler)


if __name__ == "__main__":
    sys.exit(main())
