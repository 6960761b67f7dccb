from repro_torch.data.synthetic import (
    MCDataset,
    load_movielens_csv,
    lowrank_problem,
    movielens_proxy,
)

__all__ = ["MCDataset", "load_movielens_csv", "lowrank_problem",
           "movielens_proxy"]
