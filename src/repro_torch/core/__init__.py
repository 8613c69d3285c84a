"""TTQ core: groupwise QDQ, activation statistics, KV quantization, policy,
low-rank factors, the quantized weight type."""
from .awq import (AWQConfig, accumulate_stats, activation_diag, awq_loss,
                  awq_qdq, awq_quantize, diag_from_stats)
from .gptq import gptq_qdq
from .kvquant import BF16_KV, KVCacheConfig, dequantize_kv, quantize_kv
from .lowrank import (alternating_refine, svd_factors, ttq_lowrank_qdq,
                      ttq_lowrank_quantize)
from .policy import (FUSED_KERNELS, KernelConfig, NO_QUANT, QuantPolicy,
                     override, ttq_policy)
from .qdq import (QuantConfig, dequantize, pack_bits, pack_int4, qdq,
                  quantize, rtn, unpack_bits, unpack_int4)
from .ttq import (QuantizedTensor, calibrate, dequant, init_lowrank_tree,
                  qt_index, quantize_params, quantize_weight, ttq_linear,
                  ttq_matmul)

__all__ = [
    "AWQConfig", "BF16_KV", "FUSED_KERNELS", "KVCacheConfig", "KernelConfig",
    "NO_QUANT", "QuantConfig", "QuantPolicy", "QuantizedTensor",
    "accumulate_stats", "activation_diag", "alternating_refine", "awq_loss",
    "awq_qdq", "awq_quantize", "calibrate", "dequant", "dequantize",
    "dequantize_kv", "diag_from_stats", "gptq_qdq", "init_lowrank_tree",
    "override", "pack_bits", "pack_int4", "qdq", "qt_index", "quantize",
    "quantize_kv", "quantize_params", "quantize_weight", "rtn", "svd_factors", "ttq_linear", "ttq_lowrank_qdq",
    "ttq_lowrank_quantize", "ttq_matmul", "ttq_policy", "unpack_bits",
    "unpack_int4",
]
