"""Hand-written CUDA kernels of the port and their plain PyTorch versions.

    sddmm/               sparse f-gradient: segment (sorted) and scatter
    masked_factor_grad/  dense f-gradient
    quant/               int8 dequantize-score product of the serving path
    flash_attention/     attention of the LM prefill
    csrc/                the CUDA C++ sources (sm_90a), built by _build.py

Each ``ops.py`` wrapper launches its kernel for CUDA tensors and runs the
plain version (``ref.py`` / ``segment.py``) for CPU tensors.
"""
