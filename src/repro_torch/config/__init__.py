"""The paper's workload configuration (a copy of
``repro.config.GossipMCConfig``; the LM configs are not part of the port
yet)."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class GossipMCConfig:
    """The paper's own workload (matrix completion through gossip)."""

    m: int = 500
    n: int = 500
    p: int = 4                         # grid rows
    q: int = 4                         # grid cols
    rank: int = 5
    rho: float = 1e3                   # consensus weight (paper Table 1)
    lam: float = 1e-9                  # regularization λ
    a: float = 5.0e-4                  # step size γ_t = a / (1 + b t)
    b: float = 5.0e-7
    density: float = 0.2               # observed fraction
    mode: str = "wave"                 # sequential | wave | full
    seed: int = 0

    def __post_init__(self) -> None:
        # catch bad configs at construction with the fix spelled out, not
        # deep inside blockify / the step functions
        if self.rank <= 0:
            raise ValueError(f"rank must be positive, got rank={self.rank}")
        if self.p <= 0 or self.q <= 0:
            raise ValueError(
                f"grid must have positive dimensions, got {self.p}x{self.q}"
            )
        if self.p > self.m or self.q > self.n:
            raise ValueError(
                f"grid {self.p}x{self.q} has more blocks than the {self.m}x"
                f"{self.n} matrix has rows/cols; shrink p/q (need p <= m and "
                "q <= n)"
            )
        if not 0.0 < self.density <= 1.0:
            raise ValueError(
                f"density must be in (0, 1], got {self.density}"
            )
        if self.a <= 0 or self.b < 0:
            raise ValueError(
                f"step-size schedule needs a > 0 and b >= 0 "
                f"(gamma_t = a/(1+bt)), got a={self.a}, b={self.b}"
            )
        if self.rho < 0 or self.lam < 0:
            raise ValueError(
                f"rho and lam must be non-negative, got rho={self.rho}, "
                f"lam={self.lam}"
            )
        if self.mode not in ("sequential", "wave", "full", "gossip"):
            raise ValueError(
                f"unknown mode {self.mode!r}; expected 'sequential', 'wave', "
                "'full' or 'gossip'"
            )
