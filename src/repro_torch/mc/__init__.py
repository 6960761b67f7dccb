"""``repro_torch.mc`` — the matrix-completion session API of the port.

    CompletionProblem — owns the data (dense or sorted-COO layout) on one
                        device, the grid spec, and the engine options
    Trainer           — one ``fit(problem, schedule=...)`` with the
                        Sequential / Wave / FullGD / Gossip schedules, and
                        ``refit`` (Incremental by default) after an append
    FitResult         — final State, loss trace, wall time, and
                        ``.to_recommend_index()`` / ``.to_service()`` /
                        ``.to_engine()`` into serving
"""

from repro_torch.mc.callbacks import Callback, EvalRMSE
from repro_torch.mc.problem import CompletionProblem, EngineOptions
from repro_torch.mc.schedules import (
    FullGD,
    Gossip,
    Incremental,
    Schedule,
    Sequential,
    Wave,
    make_schedule,
)
from repro_torch.mc.trainer import FitResult, Trainer

__all__ = [
    "Callback",
    "CompletionProblem",
    "EngineOptions",
    "EvalRMSE",
    "FitResult",
    "FullGD",
    "Gossip",
    "Incremental",
    "Schedule",
    "Sequential",
    "Trainer",
    "Wave",
    "make_schedule",
]
