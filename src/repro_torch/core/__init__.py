"""TTQ core: groupwise QDQ, activation statistics, KV quantization, policy,
the quantized weight type."""
from .awq import AWQConfig, awq_quantize, diag_from_stats
from .kvquant import BF16_KV, KVCacheConfig, dequantize_kv, quantize_kv
from .policy import (FUSED_KERNELS, KernelConfig, NO_QUANT, QuantPolicy,
                     override, ttq_policy)
from .qdq import QuantConfig, dequantize, pack_bits, quantize, unpack_bits
from .ttq import (QuantizedTensor, dequant, qt_index, quantize_weight,
                  ttq_linear, ttq_matmul)

__all__ = [
    "AWQConfig", "BF16_KV", "FUSED_KERNELS", "KVCacheConfig", "KernelConfig",
    "NO_QUANT", "QuantConfig", "QuantPolicy", "QuantizedTensor",
    "awq_quantize", "dequant", "dequantize", "dequantize_kv",
    "diag_from_stats", "override", "pack_bits", "qt_index", "quantize",
    "quantize_kv", "quantize_weight", "ttq_linear", "ttq_matmul",
    "ttq_policy", "unpack_bits",
]
