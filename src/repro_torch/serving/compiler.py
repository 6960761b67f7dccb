"""Per-bucket readying of the score + mask + top-k serving program.

Port of ``repro.serving.compiler``.  The JAX package lowers and compiles
one executable per bucket at startup.  PyTorch runs eagerly, so the
port's counterpart is one callable per bucket — ``recommend_topk`` at that
bucket's batch size — **run once at startup** on a zero batch of that
size.  That run builds and loads the kernel library (on the calling
thread, never first on the serving worker) and warms cuBLAS, ``topk`` and
the caching allocator at the bucket's shapes, so no request pays them.

Given a ``ShardedRecommendIndex`` (``shard_index``'s, this rank's item
shard) each callable is the two-stage query ``recommend_topk_sharded``
over ``group``; its startup run is collective, so every rank readies the
same buckets in the same order.

Factor buffers are *arguments* of the callables, not captured state:
``ServingEngine.refresh`` swaps in a new index of the same shapes and
every callable keeps running.  (A CUDA graph per bucket would capture
buffer addresses, so refresh would have to copy into them; that is a
later change.)  Every bucket increments ``serve_compiles_total`` and
``serve_bucket_compiles_total{bucket}`` once, so the invariant
``serve_compiles_total == len(buckets)`` keeps its meaning: nothing is
readied at serve time.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

from repro_torch import obs
from repro_torch.serve.recommend import (ShardedRecommendIndex,
                                        recommend_topk,
                                        recommend_topk_sharded)
from repro_torch.serving.buckets import BucketLadder


def compile_buckets(index, ladder: BucketLadder, k: int, exclude_seen: bool,
                    method=None, group=None) -> Dict[int, Callable]:
    """Ready one callable per bucket; returns {bucket: run}.

    Each ``run(index_like, user_ids)`` takes the *current* index of the
    startup one's kind (f32 or its int8 twin, or a
    ``ShardedRecommendIndex`` of either) and a padded (bucket,)-shaped
    int32 user array, and returns (items, scores) tensors of shape
    (bucket, k) on the index's device.  ``method`` is the resolved
    quantized scoring method (ignored for the f32 layout); ``group`` the
    process group of a sharded index's collective."""

    if isinstance(index, ShardedRecommendIndex):
        device = index.index.seen.device

        def run(idx, user_ids):
            return recommend_topk_sharded(idx, user_ids, k=k,
                                          exclude_seen=exclude_seen,
                                          method=method, group=group)
    else:
        device = index.seen.device

        def run(idx, user_ids):
            return recommend_topk(idx, user_ids, k=k,
                                  exclude_seen=exclude_seen, method=method)

    runs: Dict[int, Callable] = {}
    for bucket in ladder.sizes:
        run(index, torch.zeros((bucket,), dtype=torch.int32, device=device))
        runs[bucket] = run
        obs.counter("serve_compiles_total").inc()
        obs.counter("serve_bucket_compiles_total", bucket=str(bucket)).inc()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return runs
