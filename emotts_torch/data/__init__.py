from emotts_torch.data.datasets import (
    FS2Dataset,
    FS2Example,
    RankPairDataset,
    RankPairExample,
    collate_fs2,
    collate_rank_pairs,
    pick_bucket,
)
from emotts_torch.data.loader import BucketLoader
from emotts_torch.data.splits import build_fs2_splits, build_rank_pair_lists

__all__ = [
    "BucketLoader",
    "FS2Dataset",
    "FS2Example",
    "RankPairDataset",
    "RankPairExample",
    "build_fs2_splits",
    "build_rank_pair_lists",
    "collate_fs2",
    "collate_rank_pairs",
    "pick_bucket",
]
