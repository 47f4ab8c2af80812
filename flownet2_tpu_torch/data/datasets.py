"""Optical-flow datasets as direct file streams, and the packed formats
(flownet2_tpu/data/datasets.py).

Layouts: FlyingChairs (its official layout and the in-tree examples
layout), ChairsSDHom and FlyingThings3D (PFM flow), MPI-Sintel and KITTI
2015 (16-bit PNG flow, decoded by ``core/flow_io.read_kitti_flow``); 8-bit
PNG frames go through PIL. Packed: ``.flowrec`` records, LMDB and LevelDB
(``data/records``, ``data/lmdb``, ``data/leveldb``). Range subsetting and
the seeded block-wise shuffle mirror the reference's CustomData options
(custom_data_layer.cpp:29-42; DataParameter range/rand_permute/block_size,
caffe.proto:972-985).
"""

from __future__ import annotations

import glob as globmod
import os
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np

from flownet2_tpu_torch.core.flow_io import read_flo, read_image, read_kitti_flow, read_pfm


@dataclass(frozen=True)
class FlowSample:
    img0_path: str
    img1_path: str
    flow_path: str

    def load(self) -> dict:
        """{"img0", "img1": (H, W, 3), "flow": (H, W, 2)}, all float32; the
        flow from ``.flo`` or the first two channels of a ``.pfm``."""
        if self.flow_path.lower().endswith(".pfm"):
            flow = read_pfm(self.flow_path)[0][:, :, :2]
        else:
            flow = read_flo(self.flow_path)
        return {
            "img0": read_image(self.img0_path).astype(np.float32),
            "img1": read_image(self.img1_path).astype(np.float32),
            "flow": flow.astype(np.float32),
        }


@dataclass(frozen=True)
class KittiSample(FlowSample):
    """A KITTI pair: the flow from the 16-bit PNG, NaN where invalid."""

    def load(self) -> dict:
        return {
            "img0": read_image(self.img0_path).astype(np.float32),
            "img1": read_image(self.img1_path).astype(np.float32),
            "flow": read_kitti_flow(self.flow_path),
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


def ChairsSDHom(root: str, split: str = "train") -> FlowPairDataset:
    """ChairsSDHom: data/<split>/{t0,t1,flow}/NNNNN.{png,pfm}."""
    base = os.path.join(root, "data", split)
    samples = []
    for fp in sorted(globmod.glob(os.path.join(base, "flow", "*.pfm"))):
        key = os.path.splitext(os.path.basename(fp))[0]
        img0 = os.path.join(base, "t0", key + ".png")
        img1 = os.path.join(base, "t1", key + ".png")
        if os.path.exists(img0) and os.path.exists(img1):
            samples.append(FlowSample(img0, img1, fp))
    return FlowPairDataset(samples)


def FlyingThings3D(root: str, split: str = "TRAIN", direction: str = "into_future") -> FlowPairDataset:
    """FlyingThings3D: frames_cleanpass/<split>/<letter>/<scene>/left/NNNN.png
    and optical_flow/<split>/<letter>/<scene>/<direction>/OpticalFlowInto*_NNNN_L.pfm;
    frame NNNN pairs with NNNN + 1 (into_future) or NNNN - 1 (into_past)."""
    img_root = os.path.join(root, "frames_cleanpass", split)
    samples = []
    for fp in sorted(globmod.glob(os.path.join(root, "optical_flow", split, "*", "*", direction, "*.pfm"))):
        parts = fp.split(os.sep)
        scene_letter, scene = parts[-4], parts[-3]
        num = int(os.path.basename(fp).split("_")[1])
        nxt = num + 1 if direction == "into_future" else num - 1
        img0 = os.path.join(img_root, scene_letter, scene, "left", f"{num:04d}.png")
        img1 = os.path.join(img_root, scene_letter, scene, "left", f"{nxt:04d}.png")
        if os.path.exists(img0) and os.path.exists(img1):
            samples.append(FlowSample(img0, img1, fp))
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


def KITTI(root: str, split: str = "training", occluded: bool = True) -> FlowPairDataset:
    """KITTI 2015: <split>/image_2/NNNNNN_1{0,1}.png with the ground truth at
    <split>/flow_{occ,noc}/NNNNNN_10.png."""
    img_root = os.path.join(root, split, "image_2")
    samples = []
    sub = "flow_occ" if occluded else "flow_noc"
    for fp in sorted(globmod.glob(os.path.join(root, split, sub, "*_10.png"))):
        key = os.path.basename(fp)[:6]
        img0 = os.path.join(img_root, f"{key}_10.png")
        img1 = os.path.join(img_root, f"{key}_11.png")
        if os.path.exists(img0) and os.path.exists(img1):
            samples.append(KittiSample(img0, img1, fp))
    return FlowPairDataset(samples)


_FACTORIES = {
    "flyingchairs": FlyingChairs,
    "chairssdhom": ChairsSDHom,
    "flyingthings3d": FlyingThings3D,
    "sintel": Sintel,
    "kitti": KITTI,
}
PACKED_FORMATS = ("flowrec", "lmdb", "leveldb")


def open_dataset(name: str, root: str, **kw):
    """Open a named dataset layout, or a packed format: ``name`` "flowrec",
    "lmdb" or "leveldb", or "auto" where ``root`` looks like one (a
    ``.flowrec`` path; a ``.mdb`` file or a directory holding ``data.mdb``;
    a directory holding ``CURRENT``). A named layout is honored even where
    ``root`` holds a ``data.mdb``. ``kw`` goes to the layout's factory or to
    the LMDB / LevelDB dataset (e.g. disparity ``slice_points``)."""
    key = name.lower().replace("_", "")
    auto = key == "auto"
    if key == "flowrec" or (auto and root.endswith(".flowrec")):
        from flownet2_tpu_torch.data.records import FlowRecordReader

        return FlowRecordReader(root)
    if key == "lmdb" or (auto and (root.endswith(".mdb") or os.path.exists(os.path.join(root, "data.mdb")))):
        from flownet2_tpu_torch.data.lmdb import LmdbFlowDataset

        return LmdbFlowDataset(root, **kw)
    if key == "leveldb" or (auto and os.path.exists(os.path.join(root, "CURRENT"))):
        from flownet2_tpu_torch.data.leveldb import LevelDBFlowDataset

        return LevelDBFlowDataset(root, **kw)
    if auto:
        raise ValueError(f"cannot sniff dataset format at {root!r}; pass an explicit name "
                         f"(known: {sorted(_FACTORIES)}, {', '.join(PACKED_FORMATS)})")
    if key not in _FACTORIES:
        raise ValueError(f"unknown dataset {name!r}; known: {sorted(_FACTORIES)}, {', '.join(PACKED_FORMATS)}")
    return _FACTORIES[key](root, **kw)
