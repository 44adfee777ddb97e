"""Weight quantization of the port (counterpart of the JAX package's
``quant/``): int4 codes with per-group power-of-2 scales."""
from repro_torch.quant.int4 import (dequantize, int4_head, int4_linears,
                                    quantize_params, quantize_rtn)

__all__ = ["dequantize", "int4_head", "int4_linears", "quantize_params",
           "quantize_rtn"]
