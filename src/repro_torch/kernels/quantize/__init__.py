"""Wire-compression kernels: int8/int4 quantize, dequantize, top-k mask."""
