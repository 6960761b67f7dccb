"""``repro_torch.mc`` — the matrix-completion session API of the port.

    CompletionProblem — owns the data (dense or sorted-COO layout) on one
                        device, the grid spec, and the engine options
    Trainer           — one ``fit(problem, schedule=...)`` with the
                        Sequential / Wave / FullGD / Gossip schedules, and
                        ``refit`` (Incremental by default) after an append
    FitResult         — final State, loss trace, wall time, recovery log,
                        and ``.to_recommend_index()`` / ``.to_service()`` /
                        ``.to_engine()`` into serving
    Callbacks         — EvalRMSE, BenchLogger, Telemetry, Checkpoint
                        (``Trainer.fit(resume_from=..., recovery=...)``)
"""

from repro_torch.faults import (
    DivergenceError,
    DivergenceGuard,
    FaultPlan,
    RecoveryPolicy,
)
from repro_torch.mc.callbacks import (
    BenchLogger,
    Callback,
    Checkpoint,
    EvalRMSE,
    Telemetry,
    restore_session,
)
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
    "BenchLogger",
    "Callback",
    "Checkpoint",
    "CompletionProblem",
    "DivergenceError",
    "DivergenceGuard",
    "EngineOptions",
    "EvalRMSE",
    "FaultPlan",
    "FitResult",
    "FullGD",
    "Gossip",
    "Incremental",
    "RecoveryPolicy",
    "Schedule",
    "Sequential",
    "Telemetry",
    "Trainer",
    "Wave",
    "make_schedule",
    "restore_session",
]
