"""The LM harness of the port (dense, MoE, SSM, hybrid, encoder-decoder
and VLM families):
``build_model(cfg, ctx)`` gives a ``Model`` whose ``init``/``prefill``/``decode``/``init_cache`` keep
the JAX package's parameter and cache trees (``repro.models``)."""

from repro_torch.models.api import Model, build_model
from repro_torch.models.transformer import Ctx

__all__ = ["Ctx", "Model", "build_model"]
