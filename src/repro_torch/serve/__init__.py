"""``repro_torch.serve`` — matrix-completion serving: the top-k index (f32
and its int8 twin) and its fixed-batch front end.  ``repro_torch.serving``
wraps them in the bucket-batched engine."""

from repro_torch.serve.quant import (
    QuantizedRecommendIndex,
    index_nbytes,
    quantize_index,
    quantize_rows,
)
from repro_torch.serve.recommend import (
    RecommendIndex,
    RecommendService,
    ShardedRecommendIndex,
    build_index,
    build_seen_table,
    build_seen_table_coo,
    recommend_topk,
    recommend_topk_sharded,
    score_pairs,
    shard_index,
    topk_ordered,
)

__all__ = [
    "QuantizedRecommendIndex",
    "RecommendIndex",
    "RecommendService",
    "ShardedRecommendIndex",
    "build_index",
    "build_seen_table",
    "build_seen_table_coo",
    "index_nbytes",
    "quantize_index",
    "quantize_rows",
    "recommend_topk",
    "recommend_topk_sharded",
    "score_pairs",
    "shard_index",
    "topk_ordered",
]
