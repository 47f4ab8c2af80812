"""Data: optical-flow datasets read from files, the packed formats (``.flowrec``
records, LMDB and LevelDB, read without their native libraries), the
native record decoder (``native``), the prefetching loader and its device
staging (``DevicePrefetcher``), the training augmentation's host side and
device application with its running mean (``aug_params``,
``augment_pipeline``, ``mean``), and the device sample cache with its batch
and chunk iterators (``device_cache``): flownet2_tpu/data."""

from flownet2_tpu_torch.data.datasets import (
    KITTI,
    ChairsSDHom,
    FlowPairDataset,
    FlowSample,
    FlyingChairs,
    FlyingThings3D,
    Sintel,
    open_dataset,
)
from flownet2_tpu_torch.data.leveldb import LevelDBFlowDataset, LevelDBReader
from flownet2_tpu_torch.data.lmdb import LmdbFlowDataset, LmdbReader
from flownet2_tpu_torch.data.pipeline import BatchLoader, DevicePrefetcher
from flownet2_tpu_torch.data.records import FlowRecordReader, FlowRecordWriter

__all__ = [
    "KITTI",
    "BatchLoader",
    "DevicePrefetcher",
    "ChairsSDHom",
    "FlowPairDataset",
    "FlowRecordReader",
    "FlowRecordWriter",
    "FlowSample",
    "FlyingChairs",
    "FlyingThings3D",
    "LevelDBFlowDataset",
    "LevelDBReader",
    "LmdbFlowDataset",
    "LmdbReader",
    "Sintel",
    "open_dataset",
]
