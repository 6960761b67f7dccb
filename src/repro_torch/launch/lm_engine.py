"""Batched greedy decoding of the LM (port of ``repro.launch.lm_engine``).

``ServeLoop`` runs one prefill, then one cached decode step per generated
token, every slot of the batch at the same position.  The JAX module's
``make_serve_step``/``make_prefill_step`` shard over a JAX mesh and wait
for the mesh item.
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.models.api import Model


class ServeLoop:
    """Minimal batched greedy-decode loop."""

    def __init__(self, model: Model, params, batch_size: int, max_len: int):
        self.model = model
        self.params = params
        self.max_len = max_len
        self.batch_size = batch_size

    def generate(self, batch: dict[str, Any], num_tokens: int):
        """(B, num_tokens) int32 greedy tokens after the prompt
        ``batch["tokens"]`` (B, L).  A VLM's decode positions are absolute
        in its fused sequence: they start after its patch tokens."""

        prompt_len = batch["tokens"].shape[1]
        cfg = self.model.cfg
        extra = cfg.num_patch_tokens if cfg.family == "vlm" else 0
        if extra + prompt_len + num_tokens - 1 > self.max_len:
            raise ValueError(
                f"{extra + prompt_len} prompt positions + {num_tokens} "
                f"tokens do not fit max_len={self.max_len}")
        with torch.inference_mode():
            logits, cache = self.model.prefill(self.params, batch,
                                               self.max_len)
            tok = torch.argmax(logits, -1).to(torch.int32)
            out = [tok]
            start = extra + prompt_len - 1
            for i in range(1, num_tokens):
                logits, cache = self.model.decode(self.params, cache, tok,
                                                  start + i)
                tok = torch.argmax(logits, -1).to(torch.int32)
                out.append(tok)
        return torch.stack(out, dim=1)
