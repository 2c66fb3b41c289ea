"""Quantization, reference ops and the fused int8 kernels."""
