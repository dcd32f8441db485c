"""Dataset / DataLoader / samplers (counterpart of ``paddle_tpu.io``).

Workers produce host numpy batches, which come out of the loader as
torch CPU tensors; the caller moves them to the card.  The seeded batch
cursor makes an interrupted iteration resumable element-wise.
"""
from .dataset import (ChainDataset, ComposeDataset, ConcatDataset, Dataset,  # noqa: F401
                      IterableDataset, Subset, TensorDataset, random_split)
from .sampler import (BatchSampler, DistributedBatchSampler, RandomSampler,  # noqa: F401
                      Sampler, SequenceSampler, SubsetRandomSampler,
                      WeightedRandomSampler)
from .dataloader import DataLoader, default_collate_fn, get_worker_info  # noqa: F401

__all__ = ["Dataset", "IterableDataset", "TensorDataset", "ComposeDataset",
           "ChainDataset", "ConcatDataset", "Subset", "random_split",
           "Sampler", "SequenceSampler", "RandomSampler", "BatchSampler",
           "DistributedBatchSampler", "SubsetRandomSampler",
           "WeightedRandomSampler", "DataLoader", "default_collate_fn",
           "get_worker_info"]
