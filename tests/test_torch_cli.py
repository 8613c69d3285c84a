"""``python -m repro_torch.launch.serve`` against the reference launcher.

For each argv, the port's parser builds the ``EngineConfig`` (every field,
``guard_cfg`` included) and the policy fields the reference's parser builds
from the same flags (``repro.launch.serve.main`` run up to its engine, which
is stubbed out).  ``main([... "--smoke", "--device", "cpu"])`` runs end to
end with guards, a fault recipe, the paged pool and chunked prefill, and
its summary lines parse."""
import dataclasses
import re
import sys

import pytest

from repro_torch.launch import serve
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

BASE = ["--arch", "gemma_7b", "--smoke"]
ARGVS = {
    "defaults": [],
    "paged+slo": ["--kv-paged", "--kv-block-size", "8", "--kv-pool-blocks",
                  "20", "--no-prefix-cache", "--prefill-chunk", "16",
                  "--prefill-budget", "32", "--max-queue", "4"],
    "cadence+spec": ["--decode-chunk", "4", "--recal-tokens", "64",
                     "--recal-every", "2", "--requant-threshold", "0.1",
                     "--double-buffer", "--speculate-k", "2",
                     "--deadline-s", "3.5", "--no-guards", "--slots", "3",
                     "--max-len", "96"],
    "policy": ["--bits", "8", "--group-size", "16", "--rank", "4",
               "--attn-bits", "4", "--mlp-bits", "3", "--kv-dtype", "int4",
               "--kv-group-size", "16", "--kv-no-pallas", "--use-kernels",
               "--inject", "pool-steal"],
    "no-quant": ["--no-quant", "--kv-dtype", "int8", "--packed"],
}


class _Built(Exception):
    pass


def _policy_fields(p):
    kv = p.kvcache
    return (p.method, p.qcfg.bits, p.qcfg.group_size, p.rank, p.packed,
            kv.dtype, kv.group_size, kv.use_pallas, p.kernel.use_pallas,
            tuple(p.overrides))


@pytest.fixture(scope="module")
def reference():
    pytest.importorskip("jax")
    import repro.models.lm as jlm
    import repro.serving as jserving
    from repro.launch import serve as jserve

    def run(argv):
        got = {}

        class Stub:
            def __init__(self, cfg, params, policy, ecfg, **kw):
                got.update(ecfg=ecfg, policy=policy)
                raise _Built

        saved = (sys.argv, jserving.TTQEngine, jlm.init_params)
        sys.argv = ["serve"] + argv
        jserving.TTQEngine, jlm.init_params = Stub, lambda *a, **k: None
        try:
            with pytest.raises(_Built):
                jserve.main()
        finally:
            sys.argv, jserving.TTQEngine, jlm.init_params = saved
        return got
    return run


@pytest.mark.parametrize("case", list(ARGVS))
def test_flags_build_the_reference_engine_config(reference, case):
    argv = BASE + ARGVS[case]
    want = reference(argv)
    args = serve.build_parser().parse_args(argv)
    got = serve.engine_config(args)
    assert dataclasses.asdict(got) == dataclasses.asdict(want["ecfg"])
    assert _policy_fields(serve.build_policy(args)) == \
        _policy_fields(want["policy"])


def test_port_flags_and_refusals():
    ap = serve.build_parser()
    assert ap.parse_args(BASE).device == "cuda"          # the card by default
    with pytest.raises(SystemExit):
        ap.parse_args(["--arch", "llama3_8b"])           # not ported
    with pytest.raises(SystemExit):
        ap.parse_args(BASE + ["--inject", "nonsense"])
    with pytest.raises(ValueError, match="paged KV cache supports plain"):
        serve.main(["--arch", "mamba2_1p3b", "--smoke", "--kv-paged",
                    "--device", "cpu"])          # the reference's refusal


def test_main_end_to_end_on_the_cpu(capsys):
    eng, outs = serve.main(BASE + [
        "--device", "cpu", "--requests", "3", "--max-new", "4",
        "--kv-paged", "--kv-dtype", "int8", "--prefill-chunk", "16",
        "--deadline-s", "60", "--inject", "nan-stats"])
    lines = capsys.readouterr().out.splitlines()
    head = {ln.split(":")[0] for ln in lines if ":" in ln}
    assert {"kv-cache", "weight kernels", "decode-chunk", "guards",
            "latency", "slo", "kv-pool", "faults fired"} <= head
    summary = next(ln for ln in lines if ln.startswith("arch="))
    kv = dict(re.findall(r"(\w[\w/]*)=([^\s]+)", summary))
    assert kv["requests"] == "3" and int(kv["tokens"]) == 12
    lat = next(ln for ln in lines if ln.startswith("latency:"))
    assert re.search(r"ttft p50/p99 [\d.]+/[\d.]+ ms, itl p50/p99 "
                     r"[\d.]+/[\d.]+ ms \(3 streams\)", lat)
    g = next(ln for ln in lines if ln.startswith("guards: calib"))
    counters = dict(re.findall(r"(\w+)=(\d+)", g))
    assert int(counters["calib_rejections"]) == eng.calib_rejections == 1
    assert "calib.stats@1" in next(ln for ln in lines
                                   if ln.startswith("faults fired"))
    assert all(len(v) == 4 and not v.error for v in outs.values())
    eng.allocator.assert_quiescent()
