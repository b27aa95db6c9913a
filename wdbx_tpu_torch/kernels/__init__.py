"""Low-level device code: quantization and the hand-written CUDA
scoring kernels with their plain PyTorch versions."""

from wdbx_tpu_torch.kernels.quant import dequantize_rows, quantize_rows

__all__ = ["quantize_rows", "dequantize_rows"]
