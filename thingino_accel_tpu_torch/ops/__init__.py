"""Quantization, reference ops and the fused int8 kernels.

The package exports the quantization helpers, as JAX's ``ops`` does."""

from thingino_accel_tpu_torch.ops.quant import (
    RoundMode, dequantize, quantize, requantize,
)

__all__ = ["RoundMode", "requantize", "quantize", "dequantize"]
