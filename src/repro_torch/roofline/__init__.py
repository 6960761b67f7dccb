"""Roofline terms of a step on the H100's peaks (port of
``repro.roofline``).  ``hlo.collective_bytes_by_kind`` parses XLA's HLO
text and has no twin: the port's records count their collective bytes
from the collectives its code makes (``launch/roofline_bench.py``)."""

from repro_torch.roofline.analysis import (HW, analyze_record, model_flops,
                                           render_table, roofline_terms)

__all__ = ["HW", "analyze_record", "model_flops", "render_table",
           "roofline_terms"]
