from repro_torch.serve.recommend import (
    RecommendIndex,
    build_index,
    build_seen_table,
    build_seen_table_coo,
    recommend_topk,
)

__all__ = ["RecommendIndex", "build_index", "build_seen_table",
           "build_seen_table_coo", "recommend_topk"]
