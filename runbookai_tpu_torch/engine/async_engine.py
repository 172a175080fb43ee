"""Async facade over :class:`EngineCore` — the host program's serving loop.

``generate`` awaits a completion event while the engine loop task keeps
stepping the device for other live sequences. Device work runs in a worker
thread (``asyncio.to_thread``) so the event loop stays free; a lock
serializes core mutation between ``submit`` and ``step``.
"""

from __future__ import annotations

import asyncio
import logging
import threading
from typing import Optional

from runbookai_tpu_torch.engine.engine import EngineCore
from runbookai_tpu_torch.engine.request import (
    EngineOutput,
    EngineRequest,
    FinishReason,
    SamplingParams,
)


class AsyncEngine:
    def __init__(self, core: EngineCore):
        self.core = core
        self._lock = threading.Lock()
        self._wake: Optional[asyncio.Event] = None
        self._task: Optional[asyncio.Task] = None
        self._stopped = False
        # Monotonic count of engine-loop crashes (step exceptions).
        self.crash_count = 0

    async def start(self) -> None:
        # A done task means the loop that owned it was torn down (e.g. a
        # caller drives each turn with its own asyncio.run): restart on the
        # current loop, with a wake event bound to it.
        if self._task is not None and self._task.done():
            try:
                self._task.exception()  # retrieve it: already reported
            except asyncio.CancelledError:
                pass
            self._task = None
        if self._task is None:
            self._wake = asyncio.Event()
            self._stopped = False
            self._task = asyncio.create_task(self._loop(), name="engine-loop")

    async def stop(self) -> None:
        self._stopped = True
        if self._wake:
            self._wake.set()
        task, self._task = self._task, None
        if task is not None:
            try:
                await task
            except asyncio.CancelledError:
                if not task.cancelled():
                    raise  # the cancellation targeted stop() itself
            except Exception:  # noqa: BLE001
                pass  # step crash — already reported by _fail_live_requests

    async def _loop(self) -> None:
        while not self._stopped:
            with self._lock:
                has_work = self.core.has_work
            if not has_work:
                self._wake.clear()
                await self._wake.wait()
                continue
            try:
                await asyncio.to_thread(self._locked_step)
            except Exception:  # noqa: BLE001 — step blew up (e.g. device error)
                # Fail every live request now, or their awaiters would wait
                # forever; the next caller's start() restarts the loop.
                self.crash_count += 1
                self._fail_live_requests()
                raise

    def _fail_live_requests(self) -> None:
        logging.getLogger(__name__).exception(
            "engine step failed; aborting live requests")
        with self._lock:
            for req in list(self.core.waiting) + list(self.core.prefilling) \
                    + list(self.core.decoding):
                try:
                    self.core.abort(req.request_id)
                except Exception:  # noqa: BLE001 — core state corrupted
                    self.core.force_finish(req)

    def _locked_step(self) -> None:
        with self._lock:
            self.core.step()

    def _submit(self, req: EngineRequest) -> None:
        with self._lock:
            self.core.submit(req)
        self._wake.set()

    async def generate(
        self,
        prompt_ids: list[int],
        sampling: Optional[SamplingParams] = None,
        timeout_s: Optional[float] = None,
        priority: int = 0,
    ) -> EngineOutput:
        """Submit one request and await its completion. With ``timeout_s``
        a stalled generation is aborted in the engine before
        ``TimeoutError`` propagates."""
        await self.start()
        req = EngineRequest(prompt_ids=prompt_ids,
                            sampling=sampling or SamplingParams(),
                            priority=priority)
        loop = asyncio.get_running_loop()
        done = loop.create_future()

        class _Event:
            """done_event.set() runs on the worker thread: bridge it."""

            def set(self_inner) -> None:  # noqa: N805
                loop.call_soon_threadsafe(
                    lambda: done.done() or done.set_result(True))

        req.done_event = _Event()  # type: ignore[assignment]
        self._submit(req)
        if timeout_s is None:
            await done
        else:
            try:
                await asyncio.wait_for(done, timeout_s)
            except asyncio.TimeoutError:
                with self._lock:
                    aborted = self.core.abort(req.request_id)
                # The request can finish between the timeout and the abort
                # taking the lock: a completed generation is not a timeout.
                if not aborted and req.finish_reason not in (None, FinishReason.ABORTED):
                    return self.core.output_for(req)
                raise TimeoutError(
                    f"generation exceeded {timeout_s}s (request aborted)")
        return self.core.output_for(req)

    async def generate_stream(
        self,
        prompt_ids: list[int],
        sampling: Optional[SamplingParams] = None,
        priority: int = 0,
    ):
        """Async iterator of token ids as the engine samples them. Stop
        tokens ARE yielded (text renderers skip them, as ``output_for``
        does)."""
        await self.start()
        req = EngineRequest(prompt_ids=prompt_ids,
                            sampling=sampling or SamplingParams(),
                            priority=priority)
        loop = asyncio.get_running_loop()
        queue: asyncio.Queue = asyncio.Queue()

        def on_token(tok: int) -> None:
            loop.call_soon_threadsafe(queue.put_nowait, tok)

        class _Event:
            def set(self_inner) -> None:  # noqa: N805
                loop.call_soon_threadsafe(queue.put_nowait, None)

        req.on_token = on_token
        req.done_event = _Event()  # type: ignore[assignment]
        self._submit(req)
        try:
            while True:
                tok = await queue.get()
                if tok is None:
                    break
                yield tok
        finally:
            # Early exit: free the slot and KV pages instead of decoding to
            # max_new_tokens for nobody.
            if req.finish_reason is None:
                with self._lock:
                    self.core.abort(req.request_id)
