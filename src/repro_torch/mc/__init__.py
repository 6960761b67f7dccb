"""``repro_torch.mc`` — the matrix-completion session API of the port.

    CompletionProblem — owns the data (dense or sorted-COO layout) on one
                        device, the grid spec, and the engine options
    Trainer           — one ``fit(problem, schedule=...)`` with the
                        Sequential / Wave / FullGD schedules
    FitResult         — final State, loss trace, wall time, and
                        ``.to_recommend_index()`` into ``serve.recommend``
"""

from repro_torch.mc.callbacks import Callback, EvalRMSE
from repro_torch.mc.problem import CompletionProblem, EngineOptions
from repro_torch.mc.schedules import (
    FullGD,
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
    "Schedule",
    "Sequential",
    "Trainer",
    "Wave",
    "make_schedule",
]
