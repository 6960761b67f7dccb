"""``repro_torch.serving`` — the bucket-batched serving engine over the
completed matrix.  ``repro_torch.serve`` holds the index and the query
(``recommend_topk``); this package wraps them in a request path: a
:class:`BucketLadder` of batch shapes, one callable per bucket readied at
startup (:func:`compile_buckets`), a queue + worker thread returning
futures, and a :class:`ServingEngine` facade with hot factor refresh, the
:class:`RefreshPolicy`-driven auto-refit and ``repro_torch.obs`` metrics.
"""

from repro_torch.serving.buckets import DEFAULT_BUCKETS, BucketLadder
from repro_torch.serving.compiler import compile_buckets
from repro_torch.serving.engine import RefreshPolicy, ServingEngine

__all__ = [
    "BucketLadder",
    "DEFAULT_BUCKETS",
    "RefreshPolicy",
    "ServingEngine",
    "compile_buckets",
]
