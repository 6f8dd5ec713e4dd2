from .pipeline import DataPipeline, ShardedDataset, synthetic_shard

__all__ = ["DataPipeline", "ShardedDataset", "synthetic_shard"]
