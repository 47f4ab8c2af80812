"""Mean handling of the augmentation engine (flownet2_tpu/data/mean.py;
DataAugmentationLayer's recompute_mean / mean / mean_per_pixel,
data_augmentation_layer.cu:592-635, cpp:136-155).

Reference semantics:

- ``recompute_mean = K > 0``: a per-pixel running mean of the AUGMENTED
  images is updated for the first K iterations,
  ``mean_t = (mean_{t-1}*(t-1) + batch_mean) / t``, then frozen. Each
  iteration subtracts either the per-pixel mean (``mean_per_pixel``) or its
  spatial average per channel. The mean and the iteration counter are
  layer blobs, so they snapshot and restore (cpp:44-56).
- else ``mean: [r, g, b]``: subtract a fixed per-channel mean (cpp:142-155).

The update and the subtraction run in torch on the batch's device
(:func:`recompute_mean_and_subtract`, called by the augmentation with the
running mean attached to the batch); :class:`MeanRecompute` mirrors the
recursion on the host from the batch mean the step returns, so the copy
attached to the next step is the reference's blob state. Means are
(H, W, C), as the JAX package keeps them, so the mean files are its files.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch


def recompute_mean_and_subtract(
    images: torch.Tensor, mean: torch.Tensor, num_iter: torch.Tensor, *, window: int, per_pixel: bool
) -> tuple[torch.Tensor, torch.Tensor]:
    """One iteration of the reference recursion.

    images: (N, C, H, W) augmented batch; mean: (H, W, C) running mean
    BEFORE this iteration; num_iter: scalar, the 1-based iteration count
    (the reference increments blobs_[0] before the update).

    Returns (images - mean', batch_mean (H, W, C)), where
    mean' = (mean*(t-1) + batch_mean)/t while t <= window, else mean.
    The caller folds batch_mean into its host mirror
    (:meth:`MeanRecompute.update`).
    """
    x = images.float()
    batch_mean = torch.mean(x, dim=0).permute(1, 2, 0)  # (H, W, C)
    t = num_iter.float()
    updated = (mean * (t - 1.0) + batch_mean) / t
    mean_now = torch.where(num_iter <= window, updated, mean)
    if per_pixel:
        sub = mean_now.permute(2, 0, 1)[None]
    else:
        sub = torch.mean(mean_now, dim=(0, 1))[None, :, None, None]  # per channel
    return (x - sub).to(images.dtype), batch_mean


def subtract_fixed_mean(images: torch.Tensor, rgb_mean) -> torch.Tensor:
    """The fixed proto mean (cpp:142-155): one value per channel, everywhere."""
    m = torch.as_tensor(rgb_mean, dtype=torch.float32, device=images.device).reshape(1, -1, 1, 1)
    return (images.float() - m).to(images.dtype)


@dataclass
class MeanRecompute:
    """Host mirror of the reference's mean blobs.

    Attach the current state to each batch (:meth:`attach`), run the step,
    then :meth:`update` with the ``aug_batch_mean`` the step returned.
    ``state_dict``/``load_state_dict`` snapshot it beside the weights.
    """

    height: int
    width: int
    channels: int = 3
    window: int = 1000
    per_pixel: bool = False

    def __post_init__(self):
        self.mean = np.zeros((self.height, self.width, self.channels), np.float32)
        self.num_iter = 0

    def attach(self, batch: dict, *, key: str = "mean_image0") -> dict:
        """The batch with the running-mean arrays added, for the
        augmentation. ``key`` picks the frame (``mean_image0`` /
        ``mean_image1``): the reference wires one DataAugmentation layer,
        with its own mean blobs, per frame."""
        out = dict(batch)
        out[key] = self.mean
        out["mean_iter"] = np.asarray(self.num_iter + 1, np.int32)  # 1-based
        return out

    def update(self, batch_mean: np.ndarray) -> None:
        """Fold one iteration's batch mean in (cu:600-608)."""
        self.num_iter += 1
        t = self.num_iter
        if t <= self.window:
            self.mean = ((self.mean * (t - 1)) + np.asarray(batch_mean, np.float32)) / t

    @property
    def per_channel(self) -> np.ndarray:
        return self.mean.mean(axis=(0, 1))

    def state_dict(self) -> dict:
        return {"mean": self.mean.copy(), "num_iter": self.num_iter}

    def load_state_dict(self, d: dict) -> None:
        mean = np.asarray(d["mean"], np.float32)
        if mean.shape != self.mean.shape:
            raise ValueError(f"mean shape {mean.shape} != {self.mean.shape}")
        self.mean = mean
        self.num_iter = int(d["num_iter"])

    def write_mean(self, path: str) -> str:
        """Dump the running mean (the ``write_mean`` debug option,
        caffe.proto:496) as a float blob (``tools.writers.read_float_blob``
        reads it) and a .ppm preview."""
        from flownet2_tpu_torch.core.flow_io import write_ppm
        from flownet2_tpu_torch.tools.writers import _write_float_blob

        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        _write_float_blob(path, self.mean)
        preview = np.clip(self.mean * 255.0, 0, 255).astype(np.uint8)
        write_ppm(os.path.splitext(path)[0] + ".ppm", preview)
        return path

    @classmethod
    def from_mean_file(cls, path: str, *, window: int = 0, per_pixel: bool = True) -> "MeanRecompute":
        """Load a precomputed per-pixel mean (the reference's mean-file
        restore); window 0 freezes it."""
        from flownet2_tpu_torch.tools.writers import read_float_blob

        mean = np.asarray(read_float_blob(path), np.float32)
        if mean.ndim != 3:
            raise ValueError(f"mean blob must be (H, W, C), got {mean.shape}")
        obj = cls(*mean.shape, window=window, per_pixel=per_pixel)
        obj.mean = mean
        obj.num_iter = max(window, 1)
        return obj
