"""Optical-flow datasets as direct file streams (flownet2_tpu/data/datasets.py).

The layouts whose readers the port has (``core/flow_io``: PPM, ``.flo``,
and PNG through PIL): FlyingChairs, in both its official layout and the
in-tree examples layout, and MPI-Sintel. Range subsetting and the seeded
block-wise shuffle mirror the reference's CustomData options
(custom_data_layer.cpp:29-42; DataParameter range/rand_permute/block_size,
caffe.proto:972-985).
"""

from __future__ import annotations

import glob as globmod
import os
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np

from flownet2_tpu_torch.core.flow_io import read_flo, read_image


@dataclass(frozen=True)
class FlowSample:
    img0_path: str
    img1_path: str
    flow_path: str

    def load(self) -> dict:
        """{"img0", "img1": (H, W, 3), "flow": (H, W, 2)}, all float32."""
        return {
            "img0": read_image(self.img0_path).astype(np.float32),
            "img1": read_image(self.img1_path).astype(np.float32),
            "flow": read_flo(self.flow_path).astype(np.float32),
        }


class FlowPairDataset:
    """A list of (img0, img1, flow) triples with reference-style subsetting."""

    def __init__(self, samples: Sequence[FlowSample]):
        if not samples:
            raise ValueError("dataset is empty")
        self.samples = list(samples)

    def __len__(self) -> int:
        return len(self.samples)

    def __getitem__(self, i: int) -> dict:
        return self.samples[i].load()

    def subset_range(self, start: int, end: int) -> "FlowPairDataset":
        """The DataParameter ``range`` option: sample indices [start, end]."""
        return FlowPairDataset(self.samples[start : end + 1])

    def permutation(self, seed: Optional[int], block_size: int = 1) -> np.ndarray:
        """Seeded block-wise shuffle: indices permuted in contiguous blocks of
        ``block_size``, so reads stay sequential within a block."""
        n = len(self.samples)
        if seed is None:
            return np.arange(n)
        rng = np.random.default_rng(seed)
        n_blocks = (n + block_size - 1) // block_size
        idx = []
        for b in rng.permutation(n_blocks):
            lo = b * block_size
            idx.extend(range(lo, min(lo + block_size, n)))
        return np.asarray(idx)


def _pairs_from_patterns(root: str, img0_pat: str, img1_pat: str, flow_pat: str) -> list[FlowSample]:
    """Match flow files by the glob pattern; the '*' part is the sample key."""
    flow_suffix = flow_pat.split("*")[-1]
    samples = []
    for fp in sorted(globmod.glob(os.path.join(root, flow_pat))):
        key = os.path.basename(fp)[: -len(flow_suffix)]
        img0 = os.path.join(root, img0_pat.replace("*", key))
        img1 = os.path.join(root, img1_pat.replace("*", key))
        if os.path.exists(img0) and os.path.exists(img1):
            samples.append(FlowSample(img0, img1, fp))
    return samples


def FlyingChairs(root: str) -> FlowPairDataset:
    """The in-tree examples layout (NNNNNNN-img0.ppm/-img1.ppm/-gt.flo) or the
    official one (NNNNN_img1.ppm/_img2.ppm/_flow.flo)."""
    samples = _pairs_from_patterns(root, "*-img0.ppm", "*-img1.ppm", "*-gt.flo")
    if not samples:
        samples = _pairs_from_patterns(root, "*_img1.ppm", "*_img2.ppm", "*_flow.flo")
    return FlowPairDataset(samples)


def Sintel(root: str, split: str = "training", render: str = "clean") -> FlowPairDataset:
    """MPI-Sintel: <split>/<render>/<scene>/frame_NNNN.png with the ground
    truth at <split>/flow/<scene>/frame_NNNN.flo (PNG needs PIL)."""
    img_root = os.path.join(root, split, render)
    samples = []
    for fp in sorted(globmod.glob(os.path.join(root, split, "flow", "*", "frame_*.flo"))):
        scene = os.path.basename(os.path.dirname(fp))
        num = int(os.path.basename(fp)[6:10])
        img0 = os.path.join(img_root, scene, f"frame_{num:04d}.png")
        img1 = os.path.join(img_root, scene, f"frame_{num + 1:04d}.png")
        if os.path.exists(img0) and os.path.exists(img1):
            samples.append(FlowSample(img0, img1, fp))
    return FlowPairDataset(samples)


_FACTORIES = {"flyingchairs": FlyingChairs, "sintel": Sintel}


def open_dataset(name: str, root: str, **kw) -> FlowPairDataset:
    """Open a named dataset layout. The JAX package's other layouts and packed
    formats (ChairsSDHom, FlyingThings3D, KITTI, records, LMDB, LevelDB) need
    readers the port does not have yet."""
    key = name.lower().replace("_", "")
    if key not in _FACTORIES:
        raise ValueError(f"unknown or not yet ported dataset {name!r}; known: {sorted(_FACTORIES)}")
    return _FACTORIES[key](root, **kw)
