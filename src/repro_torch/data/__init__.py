"""Data pipelines of the port (numpy only, copied from the reference)."""
from .mnist import load_synthetic_mnist, partition_iid, partition_noniid
from .partition import (label_marginals, partition_dirichlet,
                        partition_quantity_skew, shard_for_device,
                        skew_score)
from .shakespeare import (VOCAB_SIZE, char_shards, char_windows,
                          load_shakespeare, split_stream)
from .tokens import TokenPipeline

__all__ = [
    "load_synthetic_mnist", "partition_iid", "partition_noniid",
    "partition_dirichlet", "partition_quantity_skew", "shard_for_device",
    "label_marginals", "skew_score",
    "VOCAB_SIZE", "char_shards", "char_windows", "load_shakespeare",
    "split_stream", "TokenPipeline",
]
