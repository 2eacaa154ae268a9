from emotts_torch.data.datasets import (
    RankPairDataset,
    RankPairExample,
    collate_rank_pairs,
    pick_bucket,
)
from emotts_torch.data.loader import BucketLoader

__all__ = [
    "BucketLoader",
    "RankPairDataset",
    "RankPairExample",
    "collate_rank_pairs",
    "pick_bucket",
]
