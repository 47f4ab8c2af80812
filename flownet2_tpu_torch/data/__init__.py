"""Data: optical-flow datasets read from files, and the prefetching loader
(flownet2_tpu/data, without its device cache and packed-record readers)."""

from flownet2_tpu_torch.data.datasets import FlowPairDataset, FlowSample, FlyingChairs, Sintel, open_dataset
from flownet2_tpu_torch.data.pipeline import BatchLoader

__all__ = ["BatchLoader", "FlowPairDataset", "FlowSample", "FlyingChairs", "Sintel", "open_dataset"]
