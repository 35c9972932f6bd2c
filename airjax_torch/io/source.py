"""IQ block sources (airjax/io/source.py): .c16 playback, a synthetic
stream on airjax_torch.io.synth, and a bounded background prefetcher.

A source is an iterator of (N, 2) int16 arrays; each matches its airjax
counterpart block for block.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Iterator, Optional

import numpy as np

from airjax_torch.io import synth
from airjax_torch.io.c16 import load_c16


def playback_blocks(
    path: str,
    chunk: int = 20000,
    realtime_factor: float | None = 2.0,
    sample_rate_hz: float = 2_000_000.0,
) -> Iterator[np.ndarray]:
    """Replay a .c16 capture in fixed chunks (airjax/io/source.py:22-45).

    Like the reference, it stops while `i < len - chunk`, dropping the tail
    including the final full chunk. realtime_factor=None replays as fast as
    possible; otherwise it sleeps chunk / (rate * factor) per chunk.
    """
    data = load_c16(path)
    sleep_s = 0.0
    if realtime_factor:
        sleep_s = chunk / (sample_rate_hz * realtime_factor)
    i = 0
    while i < len(data) - chunk:
        yield data[i : i + chunk]
        i += chunk
        if sleep_s:
            time.sleep(sleep_s)


def synthetic_blocks(
    chunk: int = 20000,
    n_blocks: int | None = None,
    frames_per_block: int = 2,
    seed: int = 0,
) -> Iterator[np.ndarray]:
    """Endless (or bounded) synthetic IQ stream with embedded DF17 traffic,
    block for block equal to airjax/io/source.py:48-79."""
    rng = np.random.default_rng(seed)
    icaos = [0x7C6B30, 0x40621D, 0xC82B10]
    b = 0
    while n_blocks is None or b < n_blocks:
        frames = []
        offsets = []
        step = max(300, chunk // max(frames_per_block, 1))
        for k in range(frames_per_block):
            icao = icaos[(b + k) % len(icaos)]
            if (b + k) % 2 == 0:
                me = synth.make_id_me("SYN" + str(100 + (b + k) % 900))
            else:
                me = synth.make_position_me(
                    tc=11,
                    altitude_ft=10000 + 25 * ((b + k) % 100),
                    cpr_lat=int(rng.integers(0, 1 << 17)),
                    cpr_lon=int(rng.integers(0, 1 << 17)),
                    odd=bool((b + k) % 2),
                )
            frames.append(synth.make_df17(icao, me))
            offsets.append(100 + k * step)
        yield synth.modulate(frames, offsets, chunk, seed=seed + b)
        b += 1


class Prefetcher:
    """Bounded background prefetch of source blocks (airjax/io/source.py:
    82-115): the source is read on a thread while blocks are decoded, with
    backpressure instead of an unbounded queue.

    The thread stamps each block as it gets it from the source; the
    iteration keeps the latest block's stamps (time.perf_counter): `got`,
    when the thread got it, `asked`, when the consumer began to wait for
    it, and `received`, when it had it. `backlog_max` is the most blocks
    the thread had got and the consumer not yet taken, at a receipt: above
    0, the consumer fell behind the source. `ready()` says, without
    waiting, whether the iteration's next step would return at once."""

    _DONE = object()

    def __init__(self, source: Iterator[np.ndarray], depth: int = 4):
        self._queue: queue.Queue = queue.Queue(maxsize=depth)
        self._thread = threading.Thread(target=self._run, args=(source,), name="Prefetcher", daemon=True)
        self._error: Optional[BaseException] = None
        self.got = self.asked = self.received = 0.0
        self.backlog_max = 0
        self._taken = self._delivered = 0
        self._thread.start()

    @property
    def thread_name(self) -> str:
        return self._thread.name

    def ready(self) -> bool:
        """Whether a block, or the stream's end, is queued: a look at the
        queue that neither waits nor takes an item."""
        return not self._queue.empty()

    def _run(self, source):
        try:
            for block in source:
                self._delivered += 1
                self._queue.put((block, time.perf_counter()))
        except BaseException as e:  # surfaced on the consumer side
            self._error = e
        finally:
            self._queue.put(self._DONE)

    def __iter__(self):
        while True:
            asked = time.perf_counter()
            item = self._queue.get()
            received = time.perf_counter()
            if item is self._DONE:
                if self._error is not None:
                    raise self._error
                return
            block, self.got = item
            self.asked, self.received = asked, received
            self._taken += 1
            self.backlog_max = max(self.backlog_max, self._delivered - self._taken)
            yield block
