from repro_torch.data.synthetic import (
    LMTokenPipeline,
    MCDataset,
    load_movielens_csv,
    lowrank_problem,
    movielens_proxy,
)

__all__ = ["LMTokenPipeline", "MCDataset", "load_movielens_csv",
           "lowrank_problem", "movielens_proxy"]
