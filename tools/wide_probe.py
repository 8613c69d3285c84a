"""Read the 2-D ``ttq_gemm``'s wide tile on one card: its tile shapes side
by side, and where it beats the split tile.

    python3 tools/wide_probe.py

Builds the kernels (``repro_torch.kernels.build``) and, apart from them,
``csrc/ttq_gemm_wide.cu`` with ``-DWIDE_PROBE`` into a library of its own
(``build/wide_probe/``), whose ``ttq_gemm_wide_probe_launch`` runs the same
kernel on other tiles (VARIANTS).  Then prints:

* registers and spills (the ``-Xptxas -v`` log) of every instantiation of
  ``wide_kernel<WG,N,KC,STG,MULTI>``;
* ``chip_smoke.kernel_wkv_b``: the served tile at deepseek-v2-lite's
  ``wkv_b`` (T = 1,024, 4,096 x 512, int4 g32) against the plain version,
  bitwise repeatable and row- and token-independent, timed beside the split
  tile, the experts' mma tile at E = 1, ``torch.matmul`` and the plain
  version;
* each variant at ``wkv_b``'s rows and T = 64, 256, 1,024 (L2 flushed),
  within [2]'s tolerance of the plain version, two calls bitwise equal, and
  whether it is bit for bit the served tile's output, beside
  ``torch.matmul``;
* the served tile and the split tile at T = 64, 256 and 1,024 on SHAPES:
  where ``kernels/ttq_gemm.py:gemm_tile``'s bounds come from.

The last line is one JSON object with the readings.  Needs a CUDA card and
the CUDA toolkit (``nvcc``).
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# variant → the tile ttq_gemm_wide_probe_launch runs (csrc/ttq_gemm_wide.cu)
VARIANTS = {0: "served: 4 warpgroups, 256 rows x 64 tokens, 64-k, 4 stages",
            1: "2 warpgroups, 128 rows x 128 tokens, 64-k, 4 stages",
            2: "2 warpgroups, 128 rows x 64 tokens, 64-k, 4 stages",
            3: "the served tile with 3 stages",
            4: "the served tile with 5 stages"}
# (d', d): wkv_b, a world-2 and a world-4 rank's wkv_b rows, d = 1,024
# (WIDE_MAX_D), and a d' of 4 row tiles (below WIDE_MIN_TILES at T = 64)
SHAPES = ((4096, 512), (2048, 512), (1024, 512), (4096, 1024), (1024, 1024))
TS = (64, 256, 1024)


def probe_lib(build):
    """``csrc/ttq_gemm_wide.cu`` built with -DWIDE_PROBE: (library, log)."""
    out = build.BUILD_DIR.parent / "wide_probe"
    out.mkdir(parents=True, exist_ok=True)
    so = out / "libwide_probe.so"
    src = build.CSRC / "ttq_gemm_wide.cu"
    res = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-DWIDE_PROBE",
                          "-I", str(build.CSRC), "-shared", "-o", str(so),
                          str(src), "-lcudart"],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{res.stdout}{res.stderr}")
    lib = ctypes.CDLL(str(so))
    P, I = ctypes.c_void_p, ctypes.c_int
    fn = lib.ttq_gemm_wide_probe_launch
    fn.argtypes = [I, P, P, P, P, P, P, I, I, I, I, P]
    fn.restype = I
    return lib, res.stdout + res.stderr


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("wide_probe: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import chip_smoke as cs
    from repro_torch.kernels import build
    build.lib()
    plib, log = probe_lib(build)
    print(cs.card_line())
    ptx = cs.ptxas_report(log)
    regs = {n: v for n, v in ptx.items() if n.startswith("wide_kernel")}
    print("registers, spill stores, spill loads: " + "; ".join(
        f"{n} {v}" for n, v in sorted(regs.items())))
    dev = torch.device("cuda")
    flush = torch.empty(64 << 20, dtype=torch.int32, device=dev)
    row = cs.kernel_wkv_b(torch, dev, flush)
    variants = by_variant(torch, cs, dev, flush, plib)
    tiles = by_shape(torch, cs, dev, flush)
    print(json.dumps({"card": cs.card_line(), "registers": regs,
                      "wkv_b": row, "variants": variants,
                      "tiles_by_shape": tiles}))
    return 0


def _case(torch, cs, dev, T, dp, d, g=32, seed=11):
    from repro_torch.kernels import ref
    gen = torch.Generator(device=dev).manual_seed(cs.SEED + seed)
    W = torch.randn((dp, d), generator=gen, device=dev) * d ** -0.5
    D = torch.exp(0.3 * torch.randn((d,), generator=gen, device=dev))
    pk, S, Z = ref.ttq_quantize_ref(W, D, bits=4, group_size=g)
    x = torch.randn((T, d), generator=gen, device=dev).to(torch.bfloat16)
    del W
    return x, pk, S, Z, 1.0 / D


def by_variant(torch, cs, dev, flush, plib) -> dict:
    """{variant: {T: µs}} at ``wkv_b``'s rows (4,096 x 512, int4 g32), L2
    flushed, each variant held to the plain version at [2]'s tolerance and
    two of its calls bitwise equal (the served one bit for bit
    ``ttq_gemm``); ``torch.matmul`` on the dequantized bf16 weight at each
    T; and which variants' outputs are bit for bit the served tile's."""
    from repro_torch.core.qdq import unpack_bits
    from repro_torch.kernels import ref
    from repro_torch.kernels.ttq_gemm import ttq_gemm
    dp, d = 4096, 512
    x, pk, S, Z, dinv = _case(torch, cs, dev, max(TS), dp, d)
    w_lib = ((unpack_bits(pk, d, 4).float() * S.repeat_interleave(32, 1)
              + Z.repeat_interleave(32, 1)) * dinv).to(torch.bfloat16)
    stream = torch.cuda.current_stream(dev).cuda_stream
    y_r = ref.ttq_gemm_ref(x, pk, S, Z, bits=4, group_size=32, dinv=dinv)
    tol = dict(rtol=2 ** -7, atol=2e-4 * (d / 256) ** 0.5)
    res, same = {}, {}
    for T in TS:
        xt = x[:T].clone()
        want = ttq_gemm(xt, pk, S, Z, dinv, bits=4, group_size=32)
        res.setdefault("torch.matmul", {})[T] = cs.time_ms(
            torch, lambda: torch.matmul(xt, w_lib.T), flush=flush) * 1e3
        for v, what in VARIANTS.items():
            y = torch.empty((T, dp), dtype=torch.bfloat16, device=dev)

            def run(v=v, y=y):
                err = plib.ttq_gemm_wide_probe_launch(
                    v, xt.data_ptr(), pk.data_ptr(), S.data_ptr(),
                    Z.data_ptr(), dinv.data_ptr(), y.data_ptr(), T, dp, d, 32,
                    stream)
                if err:
                    raise RuntimeError(f"variant {v}: CUDA error {err}")
            run()
            y1 = y.clone()
            run()
            torch.cuda.synchronize()
            cs.check(torch.equal(y, y1), f"wide variant {v}: two calls differ")
            torch.testing.assert_close(y.float(), y_r[:T], **tol)
            if v == 0:
                cs.check(torch.equal(y, want), f"wide variant 0 at T={T} is "
                         f"not the served tile")
            same.setdefault(v, []).append(bool(torch.equal(y, want)))
            res.setdefault(what, {})[T] = cs.time_ms(torch, run,
                                                      flush=flush) * 1e3
    for what, t in res.items():
        print(f"  wkv_b rows, {what}: " + ", ".join(
            f"T={T} {v:.1f} us" for T, v in t.items()))
    print(f"  bit for bit the served tile, by variant (T = {TS}): {same}")
    res["bit for bit the served tile"] = same
    return res


def by_shape(torch, cs, dev, flush) -> dict:
    """{"d'xd": {T: (wide µs, split µs)}}: both tiles forced
    (``ttq_gemm._launch``) at each of SHAPES, int4 g32, L2 flushed, both
    held to the plain version at [2]'s tolerance."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.ttq_gemm import _launch
    res = {}
    for dp, d in SHAPES:
        x, pk, S, Z, dinv = _case(torch, cs, dev, max(TS), dp, d, seed=13)
        tol = dict(rtol=2 ** -7, atol=2e-4 * (d / 256) ** 0.5)
        row = res[f"{dp}x{d}"] = {}
        for T in TS:
            xt = x[:T].clone()
            y_r = ref.ttq_gemm_ref(xt, pk, S, Z, bits=4, group_size=32,
                                   dinv=dinv)
            t = []
            for tile in ("wide", "split"):
                y = _launch(xt, pk, S, Z, dinv, 4, 32, tile)
                torch.testing.assert_close(y.float(), y_r, **tol)
                t.append(cs.time_ms(torch, lambda tile=tile: _launch(
                    xt, pk, S, Z, dinv, 4, 32, tile), flush=flush) * 1e3)
            row[T] = tuple(t)
        print(f"  {dp}x{d} int4 g32, wide / split us: " + ", ".join(
            f"T={T} {a:.1f} / {b:.1f}" for T, (a, b) in row.items()))
        del x, pk, S, Z, dinv
        torch.cuda.empty_cache()
    return res


if __name__ == "__main__":
    sys.exit(main())
