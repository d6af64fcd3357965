"""Training-data pipeline riding the two-level storage system."""

from repro_torch.data.pipeline import (
    PipelineState,
    ShardedLoader,
    SyntheticCorpus,
    plan_shard_placement,
)

__all__ = ["PipelineState", "ShardedLoader", "SyntheticCorpus", "plan_shard_placement"]
