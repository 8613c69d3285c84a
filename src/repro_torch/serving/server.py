"""TTQServer — an asyncio streaming front end over :class:`TTQEngine`.

Clients ``await server.generate(...)`` and receive tokens as the engine
emits them, instead of waiting for ``run_all``.

Threading: the engine is single-threaded device code.  Every engine call
(``submit``, ``step``, ``cancel``) happens on ONE worker thread that the
server owns, so the runner's side stream, events and CUDA-graph captures
(``torch.cuda.current_stream()`` is per thread, and a capture in the
default global mode must not meet CUDA work from another thread) all
happen there.  The asyncio side does no device work; it only touches
queues, futures and a semaphore:

* **submit**: a coroutine enqueues a command and awaits a future; the
  worker calls ``engine.submit`` and resolves the future with the rid (or
  the refusal).
* **stream**: the engine's ``on_token``/``on_finish`` callbacks, fired on
  the worker inside ``step``, are host-only and forwarded into the
  consumer's ``asyncio.Queue`` with ``loop.call_soon_threadsafe``.
* **backpressure**: an ``asyncio.Semaphore`` sized to the engine's
  ``max_queue`` (held from submit to completion) makes coroutines await at
  capacity instead of meeting ``QueueFull``.
* **disconnect**: a consumer that abandons ``generate`` has the worker
  ``cancel(rid)``; the slot and any partly chunk-ingested blocks free at
  once.

A lane retried after a decode fault restarts its stream from the first
token; a consumer that needs exactly-once delivery keys on (rid, index).
"""
from __future__ import annotations

import asyncio
import queue as _queue
import threading
from typing import Optional

from .scheduler import GenResult, QueueFull


class RequestFailed(RuntimeError):
    """A streamed request landed with an error (deadline, a lane fault past
    its retries, admission retries exhausted); ``result`` holds its partial
    :class:`GenResult`."""

    def __init__(self, rid: int, result: GenResult):
        super().__init__(f"request {rid} failed: {result.error}")
        self.rid = rid
        self.result = result


class TTQServer:
    """Async streaming wrapper over one :class:`TTQEngine`::

        async with TTQServer(engine) as server:
            async for tok in server.generate(prompt, max_new=32):
                ...

    The server owns the engine while it runs: it installs the streaming
    callbacks and drives ``engine.step()`` from its worker thread whenever
    work is pending.  ``stop()`` (or leaving the ``async with``) drains
    in-flight work, then stops the worker."""

    def __init__(self, engine, max_concurrent: int = 0,
                 poll_s: float = 0.005):
        self.engine = engine
        self._limit = max_concurrent or engine.ecfg.max_queue or 16
        self.poll_s = poll_s
        self.error: Optional[BaseException] = None   # the worker's crash
        self._running = False
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._sem: Optional[asyncio.Semaphore] = None
        self._cmds: _queue.Queue = _queue.Queue()
        self._streams: dict = {}        # rid → consumer asyncio.Queue
        self._thread: Optional[threading.Thread] = None
        self._stop_evt = threading.Event()
        self._wake = threading.Event()

    # ------------------------------------------------------------ lifecycle

    async def start(self):
        if self._running:
            raise RuntimeError("server already started")
        self._loop = asyncio.get_running_loop()
        self._sem = asyncio.Semaphore(self._limit)
        self._stop_evt.clear()
        self.error = None
        self._thread = threading.Thread(target=self._run, name="ttq-engine",
                                        daemon=True)
        self._running = True
        self._thread.start()

    async def stop(self):
        """Drain in-flight work, then stop the worker thread."""
        if not self._running:
            return
        self._stop_evt.set()
        self._wake.set()
        await self._loop.run_in_executor(None, self._thread.join)
        self._running = False

    async def __aenter__(self):
        await self.start()
        return self

    async def __aexit__(self, *exc):
        await self.stop()

    # -------------------------------------------------------------- serving

    async def generate(self, prompt, max_new: int = 16, priority: int = 0,
                       deadline_s=None, frames=None):
        """Tokens as the engine emits them.  Awaits at the concurrency bound
        before submitting; abandoning the generator cancels the request.
        Raises :class:`RequestFailed` when the request lands with an error;
        a cancellation just ends the stream.  ``frames``: an
        encoder-decoder request's input (``TTQEngine.submit``)."""
        rid, done = None, False
        await self._acquire()
        try:
            rid, q = await self._open(prompt, max_new, priority, deadline_s,
                                      frames)
            while True:
                ev = await q.get()
                if isinstance(ev, GenResult):
                    done = True
                    if ev.error:
                        raise RequestFailed(rid, ev)
                    return
                yield ev
        finally:
            self._close(rid, done)

    async def complete(self, prompt, max_new: int = 16, priority: int = 0,
                       deadline_s=None, frames=None) -> GenResult:
        """A whole generation's :class:`GenResult` (an error is returned in
        ``.error``, not raised)."""
        rid, done = None, False
        await self._acquire()
        try:
            rid, q = await self._open(prompt, max_new, priority, deadline_s,
                                      frames)
            while True:
                ev = await q.get()
                if isinstance(ev, GenResult):
                    done = True
                    return ev
        finally:
            self._close(rid, done)

    async def _acquire(self):
        if not self._running:
            raise RuntimeError("server not started")
        await self._sem.acquire()

    async def _open(self, prompt, max_new, priority, deadline_s, frames):
        """Hand the submit to the worker; await the rid."""
        fut = self._loop.create_future()
        q: asyncio.Queue = asyncio.Queue()
        kw = dict(max_new=max_new, priority=priority, deadline_s=deadline_s)
        if frames is not None:
            kw["frames"] = frames
        self._cmds.put(("submit", list(prompt), kw, fut, q))
        self._wake.set()
        return await fut, q

    def _close(self, rid, done: bool):
        """Stream teardown: cancel on the worker if the consumer left
        early; release the concurrency slot either way."""
        if rid is not None and not done:
            self._cmds.put(("cancel", rid))
            self._wake.set()
        self._sem.release()

    # ------------------------------------------------------ worker thread

    def _run(self):
        """The loop that drives the engine: drain commands, step while
        there is work, wait on the wake event otherwise.  After ``start()``
        the only thread that touches the engine."""
        eng = self.engine
        eng.set_stream_callbacks(self._on_token, self._on_finish)
        try:
            while True:
                self._drain_cmds()
                sched = eng.scheduler
                if sched.has_work() or sched.has_deferred_work():
                    eng.step()
                elif self._stop_evt.is_set():
                    break
                else:
                    self._wake.wait(self.poll_s)
                    self._wake.clear()
        except Exception as e:          # the worker's crash boundary: land
            self._crash(e)              # it in every open stream
        finally:
            eng.set_stream_callbacks(None, None)

    def _drain_cmds(self):
        while True:
            try:
                cmd = self._cmds.get_nowait()
            except _queue.Empty:
                return
            if cmd[0] == "submit":
                _, prompt, kw, fut, q = cmd
                try:
                    rid = self.engine.submit(prompt, **kw)
                except (QueueFull, ValueError) as e:
                    self._call_soon(self._resolve, fut, None, e)
                    continue
                self._streams[rid] = q
                self._call_soon(self._resolve, fut, rid, None)
            elif cmd[0] == "cancel":
                self.engine.cancel(cmd[1])

    def _on_token(self, rid, tok, t):
        q = self._streams.get(rid)
        if q is not None:
            self._call_soon(q.put_nowait, int(tok))

    def _on_finish(self, rid, req):
        q = self._streams.pop(rid, None)
        if q is not None:
            res = GenResult(req.out,
                            unfinished=req.cancelled or bool(req.error),
                            cancelled=req.cancelled, error=req.error)
            self._call_soon(q.put_nowait, res)

    def _crash(self, e: BaseException):
        self.error = e
        for rid in list(self._streams):
            q = self._streams.pop(rid, None)
            if q is not None:
                res = GenResult((), unfinished=True,
                                error=f"engine worker crashed: {e!r}")
                self._call_soon(q.put_nowait, res)

    def _call_soon(self, fn, *args):
        try:
            self._loop.call_soon_threadsafe(fn, *args)
        except RuntimeError:            # the loop already closed
            pass

    def _resolve(self, fut, val, err):
        if fut.done():                  # the consumer gave up meanwhile
            if err is None and val is not None:
                self._streams.pop(val, None)    # do not orphan the request
                self._cmds.put(("cancel", val))
                self._wake.set()
            return
        if err is not None:
            fut.set_exception(err)
        else:
            fut.set_result(val)
