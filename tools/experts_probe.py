"""Read the expert-batched GEMM's two tiles on one card: what the compiler
made of them, and their times at both MoE configs' expert shapes.

    python3 tools/experts_probe.py

Builds the kernels (``repro_torch.kernels.build``), then prints:

* registers and spills (the ``-Xptxas -v`` log) of the mma tile's
  instantiations (``experts_mma_kernel<NT,GU>``, ``csrc/ttq_gemm_experts.cu``)
  and of the batched tile's int4 expert instantiations
  (``gemm_kernel<TT,4,NG,1>``, ``csrc/ttq_gemm.cu``);
* per instantiation that both MoE configs decode through (T <= 4, g32),
  counts of SASS opcodes from ``cuobjdump -sass`` on the built library:
  int-to-float conversions (I2F, I2FP), tensor-core products (HMMA), LOP3,
  FFMA, bf16x2 arithmetic (HFMA2, HADD2), float-to-bf16 packs (F2FP),
  shared loads (LDS, LDSM), async copies (LDGSTS), shuffles, barriers, and
  all instructions;
* ``chip_smoke.kernel_gemm_experts``: each expert shape's mma tile against
  the plain version, its E-independence, and its time beside the batched
  tile's (in turns), the bound, the plain version and ``torch.bmm``, per
  decode step at deepseek-v2-lite's 27 layers and llama4-scout's 9;
* at the same shapes, the mma tile beside its copy ring alone
  (``ttq_gemm_experts_mma_copies_launch``: every copy, no products, no
  conversion), in turns, each as a share of the byte bound: how much of
  what the tile misses the copies already miss.

The last line is one JSON object with the readings.  Needs a CUDA card and
the CUDA toolkit (``nvcc``, ``cuobjdump``).
"""
from __future__ import annotations

import collections
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SERVED = ("experts_mma_kernel<1,1,0>", "gemm_kernel<4,4,1,1>")
OPCODES = ("I2F", "I2FP", "HMMA", "LOP3", "FFMA", "HFMA2", "HADD2", "F2FP",
           "LDS", "LDSM", "LDGSTS", "SHFL", "BAR")
DEPTHS = {"deepseek-v2-lite": 27, "llama4-scout": 9}


def cuobjdump() -> str:
    for cand in (shutil.which("cuobjdump"), "/usr/local/cuda/bin/cuobjdump"):
        if cand and Path(cand).exists():
            return cand
    raise RuntimeError("cuobjdump not found")


def sass_counts(lib_path: Path, names, demangle) -> dict:
    """{kernel: {opcode: count, "all": count}} for the kernels in
    ``names``, from ``cuobjdump -sass`` of the shared library."""
    out = subprocess.run([cuobjdump(), "-sass", str(lib_path)],
                         capture_output=True, text=True, check=True).stdout
    counts, cur = {}, None
    for line in out.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = demangle(m.group(1))
            cur = collections.Counter() if name in names else None
            if cur is not None:
                counts[name] = cur
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)",
                     line)
        if cur is not None and m:
            op = m.group(1)
            cur["all"] += 1
            for want in OPCODES:
                if op == want:
                    cur[want] += 1
    return {n: {k: c.get(k, 0) for k in (*OPCODES, "all")}
            for n, c in counts.items()}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("experts_probe: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import chip_smoke as cs
    from repro_torch.kernels import build
    lib = build.lib()
    print(cs.card_line())
    ptx = cs.ptxas_report(build.build_log)
    regs = {n: v for n, v in ptx.items()
            if n.startswith("experts_mma_kernel")
            or re.fullmatch(r"gemm_kernel<\d,4,\d,1>", n)}
    print("registers, spill stores, spill loads: " + "; ".join(
        f"{n} {v}" for n, v in sorted(regs.items())))
    sass = sass_counts(Path(lib._name), SERVED, cs.demangle)
    for n, c in sass.items():
        print(f"SASS {n}: " + ", ".join(f"{k} {v}" for k, v in c.items()))
    dev = torch.device("cuda")
    flush = torch.empty(64 << 20, dtype=torch.int32, device=dev)
    row, by_cfg = cs.kernel_gemm_experts(torch, dev, flush, DEPTHS)
    copies = copy_ring(torch, dev, flush, cs)
    print(json.dumps({"card": cs.card_line(), "registers": regs,
                      "sass": sass, "per_step": by_cfg,
                      "copy_ring": copies}))
    return 0


def copy_ring(torch, dev, flush, cs) -> dict:
    """{config shape: (tile µs, copies µs, bound µs)}: the mma tile's C entry
    and its copy ring alone on random codes, S, Z (T = 4 bf16, g32), timed
    in turns (tile, copies, copies, tile; the mean of each's medians)."""
    from repro_torch.kernels import build
    lib = build.lib()
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    stream = torch.cuda.current_stream(dev).cuda_stream
    gen = torch.Generator(device=dev).manual_seed(cs.SEED + 9)
    out = {}
    for cfg_name, shapes in cs.EXPERT_SHAPES.items():
        for name, E, dp, d, _ in shapes:
            pk = torch.randint(-2 ** 31, 2 ** 31 - 1, (E, dp, d // 8),
                               dtype=torch.int32, device=dev, generator=gen)
            S = torch.rand((E, dp, d // 32), device=dev, generator=gen)
            Z = torch.randn((E, dp, d // 32), device=dev, generator=gen)
            dinv = torch.rand((E, d), device=dev, generator=gen) + 0.5
            shared = name != "wd"
            x = torch.randn((4, d) if shared else (E, 4, d), generator=gen,
                            device=dev).to(torch.bfloat16)
            y = torch.empty((E, 4, dp), dtype=torch.bfloat16, device=dev)

            def launch(fn):
                err = fn(x.data_ptr(), int(shared), pk.data_ptr(),
                         S.data_ptr(), Z.data_ptr(), dinv.data_ptr(),
                         y.data_ptr(), E, 4, dp, d, 32, n_sm, stream)
                if err:
                    raise RuntimeError(f"launch refused: CUDA error {err}")
            tile = lambda: launch(lib.ttq_gemm_experts_mma_launch)  # noqa: E731
            ring = lambda: launch(lib.ttq_gemm_experts_mma_copies_launch)  # noqa: E731
            t = [cs.time_ms(torch, fn, flush=flush)
                 for fn in (tile, ring, ring, tile)]
            t_k, t_c = (t[0] + t[3]) / 2, (t[1] + t[2]) / 2
            moved = cs.nbytes(pk, S, Z, dinv, x) + E * 4 * dp * 2
            b = moved / cs.HBM_BYTES_PER_S * 1e3
            key = f"{cfg_name} {name}"
            out[key] = (t_k * 1e3, t_c * 1e3, b * 1e3)
            print(f"  {key} E={E} {dp}x{d}: mma tile {t_k * 1e3:.1f} us "
                  f"({b / t_k:.1%} of the bound), its copy ring alone "
                  f"{t_c * 1e3:.1f} us ({b / t_c:.1%}), bound {b * 1e3:.1f} "
                  f"us", flush=True)
            del pk, S, Z, dinv, x, y
            torch.cuda.empty_cache()
    return out


if __name__ == "__main__":
    sys.exit(main())
