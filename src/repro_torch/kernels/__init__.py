"""Hand-written Hopper kernels of the serving path and their plain versions.

* ``ttq_quantize``         — online scaled groupwise quantize + pack;
* ``ttq_gemm``             — fused dequant GEMM with the D⁻¹ prologue;
* ``ttq_gemm_experts``     — the same over E expert weights in one launch;
* ``kv_decode_attention``  — decode attention over an int8/int4 KV cache;
* ``kv_paged_decode_attention`` — the same over a paged pool, through a
  per-slot block table.

``ops`` dispatches, ``ref`` holds the plain PyTorch versions, ``build``
compiles ``csrc/`` with nvcc at first use and counts launches.
"""
from .ops import (kv_decode_attention, kv_paged_decode_attention, ttq_gemm,
                  ttq_gemm_experts, ttq_quantize)

__all__ = ["kv_decode_attention", "kv_paged_decode_attention", "ttq_gemm",
           "ttq_gemm_experts", "ttq_quantize"]
