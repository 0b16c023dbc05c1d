"""Host data pipeline with prefetch, retries and exact resume (port of
``repro.data.pipeline.DataPipeline``).

* A background thread reads ``prefetch`` steps ahead and hands over
  batches already on the consumer's ``device``: each array is moved there
  once, through pinned host memory when the device is a card (the copy is
  queued without a host wait), so host reads overlap the device's steps.
* A read that fails is retried up to ``retries`` times with a bounded
  exponential backoff, jittered deterministically per (step, attempt).
  After the last attempt the consumer gets a typed
  :class:`~repro_torch.core.guards.PipelineError` carrying the step.
* State is the step counter: ``skip_to(step)`` restarts the stream exactly
  there, since the source is a pure function of the step.
"""
from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator, Optional

import numpy as np
import torch

from repro_torch.core.guards import PipelineError

_WORKER_FAILED = object()  # queue sentinel: the prefetch thread died


def _to_device(batch, device):
    """Arrays (or a dict of them) as tensors on ``device``; CPU data bound
    for a card goes through pinned memory and a non-blocking copy."""
    if isinstance(batch, dict):
        return {name: _to_device(v, device) for name, v in batch.items()}
    t = torch.as_tensor(batch)
    if device is None or t.device == torch.device(device):
        return t
    if torch.device(device).type == "cuda" and t.device.type == "cpu":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


class DataPipeline:
    def __init__(self, read_fn: Callable[[int], object], *,
                 start_step: int = 0, prefetch: int = 2, device=None,
                 retries: int = 3, backoff: float = 0.05):
        """``read_fn(step)`` -> an array (or a dict of arrays): the batch of
        that step. ``device``: where batches are handed over (None leaves
        them where ``read_fn`` put them)."""
        self.read_fn = read_fn
        self.step = start_step
        self.prefetch = prefetch
        self.device = device
        self.retries = max(int(retries), 1)
        self.backoff = float(backoff)
        self._q: queue.Queue = queue.Queue(maxsize=max(prefetch, 1))
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # -- lifecycle ---------------------------------------------------------
    def start(self):
        if self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(target=self._worker, daemon=True)
            self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            try:  # drain so the worker unblocks
                while True:
                    self._q.get_nowait()
            except queue.Empty:
                pass
            self._thread.join(timeout=5)
            self._thread = None

    def skip_to(self, step: int):
        """Exact resume: restart the stream at ``step`` (no replay)."""
        if self._thread is not None:
            raise RuntimeError("skip_to before start()")
        self.step = step

    # -- iteration ---------------------------------------------------------
    def _delay(self, step: int, attempt: int) -> float:
        """Backoff before retry ``attempt`` of ``step``: base·2^attempt,
        jittered ±25% deterministically per (step, attempt), capped at
        2 s."""
        u = np.random.default_rng((step << 8) ^ attempt).random()
        return min(self.backoff * (2.0 ** attempt) * (0.75 + 0.5 * u), 2.0)

    def _worker(self):
        s = self.step
        while not self._stop.is_set():
            try:
                batch = _to_device(self._read_with_retry(s), self.device)
            except BaseException as e:  # hand it to the consumer: a dead
                self._error = e         # prefetch thread must not leave
                self._put((s, _WORKER_FAILED))  # the consumer waiting
                return
            if not self._put((s, batch)):
                return
            s += 1

    def _put(self, item) -> bool:
        """Queue ``item``, giving up (False) once the pipeline stops."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue.Full:
                pass
        return False

    def _read_with_retry(self, s: int):
        for attempt in range(self.retries):
            try:
                return self.read_fn(s)
            except Exception:
                if attempt + 1 >= self.retries:
                    raise
                # stop-aware sleep: shutdown never waits out a backoff
                if self._stop.wait(self._delay(s, attempt)):
                    raise
        raise AssertionError("unreachable")  # pragma: no cover

    def _get(self):
        item = self._q.get()
        if item[1] is _WORKER_FAILED:
            raise PipelineError(
                f"DataPipeline read_fn failed at step {item[0]} after "
                f"{self.retries} attempts", step=item[0]) from self._error
        return item

    def __iter__(self) -> Iterator[tuple[int, object]]:
        self.start()
        while True:
            yield self._get()

    def __next__(self):
        self.start()
        return self._get()
