"""Bucket ladder + request router: every request becomes a padded batch
whose shape is one of a small fixed set.

A copy of ``repro.serving.buckets`` (pure geometry).  The engine readies
one callable per *bucket* (e.g. 16/64/256/1024 users) at startup and the
router maps every incoming request onto that ladder: a request of ``n``
users pads up to the smallest bucket that fits it, and a request larger
than the top bucket splits into top-bucket chunks plus one padded tail
chunk.  The pad rows are real computation on user id 0 and are sliced off
before the response — what ``RecommendService`` does for tail batches,
generalized to a ladder.

``bucket_for`` picks the bucket, and ``plan`` emits the
(start, length, bucket) chunk list whose lengths sum to ``n``.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

DEFAULT_BUCKETS: Tuple[int, ...] = (16, 64, 256, 1024)


@dataclasses.dataclass(frozen=True)
class BucketLadder:
    """Sorted, strictly increasing batch-size buckets."""

    sizes: Tuple[int, ...] = DEFAULT_BUCKETS

    def __post_init__(self) -> None:
        sizes = tuple(int(s) for s in self.sizes)
        object.__setattr__(self, "sizes", sizes)
        if not sizes:
            raise ValueError("BucketLadder needs at least one bucket size")
        if any(s <= 0 for s in sizes):
            raise ValueError(f"bucket sizes must be positive, got {sizes}")
        if any(a >= b for a, b in zip(sizes, sizes[1:])):
            raise ValueError(
                f"bucket sizes must be strictly increasing, got {sizes}"
            )

    @property
    def max_size(self) -> int:
        return self.sizes[-1]

    def bucket_for(self, n: int) -> int:
        """Smallest bucket that fits ``n`` users (1 ≤ n ≤ max_size)."""

        if n <= 0:
            raise ValueError(f"request size must be positive, got {n}")
        for s in self.sizes:
            if n <= s:
                return s
        raise ValueError(
            f"request of {n} users exceeds the top bucket {self.max_size}; "
            f"route through plan() to split it into chunks"
        )

    def plan(self, n: int) -> List[Tuple[int, int, int]]:
        """Chunk a request of ``n`` users onto the ladder.

        Returns ``[(start, length, bucket), ...]`` with lengths summing to
        ``n``: full top-bucket chunks while the remainder exceeds the top
        bucket, then one tail chunk padded up to its smallest fitting
        bucket."""

        if n <= 0:
            raise ValueError(f"request size must be positive, got {n}")
        chunks: List[Tuple[int, int, int]] = []
        start = 0
        top = self.max_size
        while n - start > top:
            chunks.append((start, top, top))
            start += top
        rest = n - start
        chunks.append((start, rest, self.bucket_for(rest)))
        return chunks
