"""The port's ``TTQServer`` on the CPU: the cases of tests/test_server.py.

The server is a pure transport: streamed tokens equal the port's batch
engine's (bit for bit), whose tokens are held to the JAX engine's on the
same bridged weights by the near-tie rule of
tests/test_torch_robustness.py; backpressure awaits instead of raising; a
consumer that walks away cancels its request without disturbing the
others; ``stop()`` drains; a worker crash lands in every open stream.
Each test drives its own ``asyncio.run``."""
import asyncio
import dataclasses

import numpy as np
import pytest

from repro_torch.bridge import params_from_jax
from repro_torch.core import NO_QUANT
from repro_torch.models.config import ModelConfig as TCfg
from repro_torch.serving import EngineConfig, TTQEngine, TTQServer

from test_torch_robustness import hold
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

PROMPTS = [[((7 * i + s) % 126) + 1 for i in range(n)]
           for s, n in ((3, 8), (5, 40), (1, 12))]


@pytest.fixture(scope="module")
def jx():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.core import NO_QUANT as J_NO_QUANT
    from repro.core import KVCacheConfig
    from repro.models import ModelConfig, lm
    from repro.serving import EngineConfig as JE
    from repro.serving import TTQEngine as JEngine
    return dict(jax=jax, jnp=jnp, lm=lm, KV=KVCacheConfig, MCfg=ModelConfig,
                NO_QUANT=J_NO_QUANT, ECfg=JE, Eng=JEngine)


@pytest.fixture(scope="module")
def bridged(jx):
    jcfg = jx["MCfg"](name="t", family="dense", n_layers=3, d_model=64,
                      n_heads=4, n_kv_heads=2, d_ff=96, vocab=128)
    jp = jx["lm"].init_params(jcfg, jx["jax"].random.PRNGKey(0))
    tp = params_from_jax(jx["jax"].tree.map(np.asarray, jp), device="cpu")
    tcfg = TCfg(**{f.name: getattr(jcfg, f.name)
                   for f in dataclasses.fields(TCfg)})
    return jcfg, jp, tcfg, tp


def _kw(**kw):
    base = dict(max_slots=2, max_len=96, decode_chunk=1, temperature=0.0,
                recalibrate_tokens=10**9, prompt_buckets=(16, 32, 64),
                prefill_chunk=16, max_queue=8)
    base.update(kw)
    return base


def _engine(bridged, **kw):
    _, _, tcfg, tp = bridged
    return TTQEngine(tcfg, tp, NO_QUANT, EngineConfig(**_kw(**kw)),
                     device="cpu")


@pytest.fixture(scope="module")
def reference(jx, bridged):
    eng = _engine(bridged)
    rids = [eng.submit(p, max_new=6) for p in PROMPTS]
    outs = eng.run_all()
    ref = [list(outs[r]) for r in rids]
    jcfg, jp, _, _ = bridged
    jeng = jx["Eng"](jcfg, jp, jx["NO_QUANT"], jx["ECfg"](**_kw()))
    jr = [jeng.submit(p, max_new=6) for p in PROMPTS]
    jouts = jeng.run_all()

    class J:
        jnp, lm, KV = jx["jnp"], jx["lm"], jx["KV"]
    hold(J, bridged, PROMPTS, [list(jouts[r]) for r in jr], ref)
    return ref


async def _streams(server, prompts, max_new=6):
    async def stream(p):
        return [t async for t in server.generate(p, max_new=max_new)]
    return await asyncio.gather(*[stream(p) for p in prompts])


def test_streams_match_batch_engine(bridged, reference):
    eng = _engine(bridged)

    async def main():
        async with TTQServer(eng) as server:
            return await _streams(server, PROMPTS)

    assert asyncio.run(main()) == reference
    assert eng.allocator is None or not eng.allocator.ref


def test_complete_returns_genresult(bridged, reference):
    eng = _engine(bridged)

    async def main():
        async with TTQServer(eng) as server:
            return await server.complete(PROMPTS[0], max_new=6)

    res = asyncio.run(main())
    assert list(res) == reference[0] and not res.unfinished and not res.error


def test_backpressure_awaits_at_capacity(bridged, reference):
    eng = _engine(bridged, max_slots=1, max_queue=1)

    async def main():
        async with TTQServer(eng) as server:
            return await _streams(server, PROMPTS)

    assert asyncio.run(main()) == reference
    assert eng.queue_rejections == 0


def test_disconnect_cancels_without_disturbing_others(bridged, reference):
    eng = _engine(bridged, kv_paged=True, kv_block_size=16)

    async def main():
        async with TTQServer(eng) as server:
            survivor = asyncio.ensure_future(
                server.complete(PROMPTS[0], max_new=6))
            agen = server.generate(PROMPTS[1], max_new=6)
            first = await agen.__anext__()
            await agen.aclose()
            return first, await survivor

    first, res = asyncio.run(main())
    assert first == reference[1][0] and list(res) == reference[0]
    assert len([r for r in eng.scheduler.finished.values()
                if r.cancelled]) == 1
    eng.allocator.assert_quiescent()


def test_immediate_disconnect_cancels_mid_prefill(bridged):
    eng = _engine(bridged, kv_paged=True, kv_block_size=16)

    async def main():
        async with TTQServer(eng) as server:
            task = asyncio.ensure_future(
                server.complete(PROMPTS[1], max_new=6))
            await asyncio.sleep(0)
            task.cancel()
            try:
                await task
            except asyncio.CancelledError:
                pass
            return await server.complete(PROMPTS[0], max_new=3)

    res = asyncio.run(main())
    assert len(res) == 3 and not res.error
    eng.allocator.assert_quiescent()


def test_stop_drains_inflight_work(bridged, reference):
    eng = _engine(bridged)

    async def main():
        server = TTQServer(eng)
        await server.start()
        task = asyncio.ensure_future(server.complete(PROMPTS[2], max_new=6))
        await asyncio.sleep(0)
        res = await task
        await server.stop()
        return res

    assert list(asyncio.run(main())) == reference[2]
    assert eng.scheduler.has_work() is False


def test_worker_crash_fails_open_streams(bridged):
    eng = _engine(bridged)

    def boom():
        raise RuntimeError("injected engine crash")
    eng.step = boom

    async def main():
        async with TTQServer(eng) as server:
            res = await asyncio.wait_for(
                server.complete(PROMPTS[0], max_new=4), timeout=30)
            return res, server.error

    res, err = asyncio.run(main())
    assert res.unfinished and "crash" in res.error
    assert isinstance(err, RuntimeError)


def test_failed_request_raises_in_the_stream(bridged):
    """A request landing with an error (here its deadline, on the engine's
    clock) raises ``RequestFailed`` in ``generate`` with its partial
    result; other streams finish."""
    from repro_torch.serving import RequestFailed
    eng = _engine(bridged)

    async def main():
        async with TTQServer(eng) as server:
            async def doomed():
                return [t async for t in server.generate(
                    PROMPTS[0], max_new=6, deadline_s=1e-9)]
            with pytest.raises(RequestFailed) as e:
                await doomed()
            return e.value, await server.complete(PROMPTS[2], max_new=6)

    err, res = asyncio.run(main())
    assert err.result.error == "deadline" and len(res) == 6
