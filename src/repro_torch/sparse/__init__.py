from repro_torch.sparse.entries import BlockEntries
from repro_torch.sparse.objective import (
    f_cost_sparse,
    f_grads_sparse,
    full_gradients_sparse,
    full_objective_sparse,
    total_report_cost_sparse,
)
from repro_torch.sparse.store import (
    DEFAULT_BUCKET,
    SparseProblem,
    bucketed_capacity,
    density,
    ensure_layout,
    from_blocks,
    from_dataset,
    from_entries,
    to_dense,
)

__all__ = [
    "BlockEntries",
    "DEFAULT_BUCKET",
    "SparseProblem",
    "bucketed_capacity",
    "density",
    "ensure_layout",
    "f_cost_sparse",
    "f_grads_sparse",
    "from_blocks",
    "from_dataset",
    "from_entries",
    "full_gradients_sparse",
    "full_objective_sparse",
    "to_dense",
    "total_report_cost_sparse",
]
