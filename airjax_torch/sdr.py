"""SDR hardware abstraction (airjax/sdr.py; the reference's src/sdr.rs and
src/adsb.rs:27-73).

The reference talks to RTL-SDR hardware through the SoapySDR C++ library
via Rust FFI. Here, as in airjax, the same path binds through SoapySDR's C
API (the 0.8 ABI) with ctypes: enumeration, device setup (gain element
"TUNER", frequency, sample rate — the reference's constants), and CS16
streaming in MTU-sized blocks.

Without a SoapySDR install every entry point raises `SdrUnavailable`. The
AIRJAX_SOAPY_LIB variable names the library to load instead of searching:
a SoapySDR outside the linker path, or the fake SoapySDR C-ABI double
(native/fake_soapysdr.c, built by native.build_fake_soapysdr), which streams
deterministic CS16 from the .c16 file AIRJAX_FAKE_SOAPY_C16 names, so the
whole FFI runs without hardware (tests/test_torch_live.py). Real hardware
also needs an RTL-SDR driver plugin.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import os
from typing import Iterator, Optional

import numpy as np

SDR_CHANNEL = 0  # src/adsb.rs:28
SDR_RX = 1  # SOAPY_SDR_RX direction constant
_STREAM_TIMEOUT_US = 2_000_000  # reference stream.read timeout (adsb.rs:62)
ring_blocks = 0  # blocks delivered through the native ring (blocks_ringbuffered)


class SdrUnavailable(RuntimeError):
    pass


def _load_soapy() -> Optional[ctypes.CDLL]:
    # AIRJAX_SOAPY_LIB overrides discovery: the fake ABI double
    # (native/fake_soapysdr.c), or a SoapySDR outside the linker path.
    path = os.environ.get("AIRJAX_SOAPY_LIB") or ctypes.util.find_library("SoapySDR")
    if path is None:
        return None
    try:
        lib = ctypes.CDLL(path)
    except OSError:
        return None
    # C API signatures (SoapySDR 0.8 ABI).
    lib.SoapySDRDevice_enumerate.restype = ctypes.c_void_p
    lib.SoapySDRDevice_enumerate.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_size_t)]
    lib.SoapySDRKwargsList_clear.argtypes = [ctypes.c_void_p, ctypes.c_size_t]
    lib.SoapySDRDevice_makeStrArgs.restype = ctypes.c_void_p
    lib.SoapySDRDevice_makeStrArgs.argtypes = [ctypes.c_char_p]
    lib.SoapySDRDevice_unmake.argtypes = [ctypes.c_void_p]
    lib.SoapySDRDevice_setGainElement.restype = ctypes.c_int
    lib.SoapySDRDevice_setGainElement.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_size_t, ctypes.c_char_p, ctypes.c_double,
    ]
    lib.SoapySDRDevice_setFrequency.restype = ctypes.c_int
    lib.SoapySDRDevice_setFrequency.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_size_t, ctypes.c_double, ctypes.c_void_p,
    ]
    lib.SoapySDRDevice_setSampleRate.restype = ctypes.c_int
    lib.SoapySDRDevice_setSampleRate.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_size_t, ctypes.c_double,
    ]
    lib.SoapySDRDevice_setupStream.restype = ctypes.c_void_p
    lib.SoapySDRDevice_setupStream.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_size_t), ctypes.c_size_t, ctypes.c_void_p,
    ]
    lib.SoapySDRDevice_activateStream.restype = ctypes.c_int
    lib.SoapySDRDevice_activateStream.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_size_t,
    ]
    lib.SoapySDRDevice_deactivateStream.restype = ctypes.c_int
    lib.SoapySDRDevice_deactivateStream.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
    ]
    lib.SoapySDRDevice_closeStream.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.SoapySDRDevice_getStreamMTU.restype = ctypes.c_size_t
    lib.SoapySDRDevice_getStreamMTU.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.SoapySDRDevice_readStream.restype = ctypes.c_int
    lib.SoapySDRDevice_readStream.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p),
        ctypes.c_size_t, ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_longlong), ctypes.c_long,
    ]
    return lib


def list_devices() -> list[str]:
    """Enumerate SDR devices (src/sdr.rs:4-10)."""
    lib = _load_soapy()
    if lib is None:
        raise SdrUnavailable(
            "SoapySDR library not found — live SDR capture requires a "
            "SoapySDR install with an RTL-SDR driver. Use --playback or the "
            "synthetic generator instead."
        )
    length = ctypes.c_size_t(0)
    kwargs_list = lib.SoapySDRDevice_enumerate(None, ctypes.byref(length))
    try:
        return [f"device {i}" for i in range(length.value)]
    finally:
        if kwargs_list:
            lib.SoapySDRKwargsList_clear(kwargs_list, length)


class SdrSource:
    """Live IQ block source at 1090 MHz / 2 MS/s (src/adsb.rs:35-73).

    Yields MTU-sized (N, 2) int16 blocks; read errors are skipped like the
    reference's `Err(_e) => continue` (src/adsb.rs:70).
    """

    def __init__(
        self,
        device: int | None = None,
        frequency_hz: float = 1_090_000_000.0,
        sample_rate_hz: float = 2_000_000.0,
        gain_db: float = 49.5,
    ):
        lib = _load_soapy()
        if lib is None:
            raise SdrUnavailable(
                "SoapySDR library not found — cannot open live SDR stream."
            )
        self._lib = lib
        args = b"" if device is None else f"driver=rtlsdr,rtl={device}".encode()
        self._dev = lib.SoapySDRDevice_makeStrArgs(args)
        if not self._dev:
            raise SdrUnavailable("couldn't create SDR device")
        if lib.SoapySDRDevice_setGainElement(
            self._dev, SDR_RX, SDR_CHANNEL, b"TUNER", gain_db
        ):
            raise SdrUnavailable("couldn't set gain")
        if lib.SoapySDRDevice_setFrequency(
            self._dev, SDR_RX, SDR_CHANNEL, frequency_hz, None
        ):
            raise SdrUnavailable("couldn't set frequency")
        if lib.SoapySDRDevice_setSampleRate(
            self._dev, SDR_RX, SDR_CHANNEL, sample_rate_hz
        ):
            raise SdrUnavailable("couldn't set sample rate")
        chan = ctypes.c_size_t(SDR_CHANNEL)
        self._stream = lib.SoapySDRDevice_setupStream(
            self._dev, SDR_RX, b"CS16", ctypes.byref(chan), 1, None
        )
        if not self._stream:
            raise SdrUnavailable("couldn't setup stream")
        self._mtu = lib.SoapySDRDevice_getStreamMTU(self._dev, self._stream) or 65536
        self._ring_workers: list = []  # (stop, thread, ring) per consumer
        lib.SoapySDRDevice_activateStream(self._dev, self._stream, 0, 0, 0)

    def blocks(self, stop=None, copy=True) -> Iterator[np.ndarray]:
        """MTU-sized int16 IQ blocks until `stop` (a threading.Event,
        optional) is set — the stop hook exists so a ring-buffered rx
        thread can be shut down BEFORE close() frees the device (a
        GIL-released readStream racing the free is a use-after-free).

        copy=False yields VIEWS into the reused read buffer, valid only
        until the next iteration — for consumers that immediately
        snapshot the data themselves (the ring producer memcpys into
        ring storage; skipping the .copy() halves its per-block memory
        traffic)."""
        buf = np.empty((self._mtu, 2), dtype=np.int16)
        ptrs = (ctypes.c_void_p * 1)(buf.ctypes.data)
        flags = ctypes.c_int(0)
        time_ns = ctypes.c_longlong(0)
        while stop is None or not stop.is_set():
            n = self._lib.SoapySDRDevice_readStream(
                self._dev,
                self._stream,
                ptrs,
                self._mtu,
                ctypes.byref(flags),
                ctypes.byref(time_ns),
                _STREAM_TIMEOUT_US,
            )
            if n <= 0:
                continue  # timeouts/overflows skipped, like the reference
            yield buf[:n].copy() if copy else buf[:n]

    def blocks_ringbuffered(self, depth: int = 16) -> "Iterator[np.ndarray]":
        """Live rx decoupled through the native lock-free SPSC ring
        (native/airjax_native.cpp `airjax_ring_*`): a daemon thread
        drains the SoapySDR stream into the ring while the consumer
        holds the GIL for host-side work — the reference's
        rx-thread -> mpsc channel architecture (src/adsb.rs:54-73) with
        a native channel instead of a Python queue. Both the Soapy read
        and the ring push/pop are GIL-releasing C calls, so a busy
        decode loop cannot starve the radio.

        Backpressure: a full ring blocks the rx thread (bounded-queue
        semantics, like io.source.Prefetcher) and lets the SDR's
        own buffering absorb the stall. Falls back to the plain
        blocks() iterator when the native library is unavailable, as
        airjax does."""
        import threading
        import time as _time

        from airjax_torch.native import NativeUnavailable, Ring

        try:
            ring = Ring(self._mtu, depth=depth)
        except (NativeUnavailable, OSError):
            yield from self.blocks()
            return

        stop = threading.Event()

        def _rx() -> None:
            try:
                # copy=False: push() snapshots into ring storage itself.
                for blk in self.blocks(stop=stop, copy=False):
                    while not ring.push(blk):
                        if stop.is_set():
                            return
                        _time.sleep(0.0005)
                    if stop.is_set():
                        return
            except Exception:
                if not stop.is_set():
                    # A genuine mid-stream failure (not shutdown): the
                    # operator must be able to tell "receiver died" from
                    # "no traffic".
                    import logging

                    logging.getLogger("airjax_torch").exception(
                        "SDR ring rx thread died mid-stream"
                    )

        thread = threading.Thread(target=_rx, daemon=True)
        # Registered so close() can stop+join the rx thread BEFORE it
        # frees the device (readStream returns within its 2 s timeout).
        self._ring_workers.append((stop, thread, ring))
        thread.start()
        global ring_blocks
        try:
            while True:
                blk = ring.pop()
                if blk is None:
                    if not thread.is_alive():
                        # Drain any block pushed between the empty pop
                        # and the liveness check before finishing.
                        while (blk := ring.pop()) is not None:
                            ring_blocks += 1
                            yield blk
                        return
                    _time.sleep(0.0005)
                    continue
                ring_blocks += 1
                yield blk
        finally:
            stop.set()
            thread.join(timeout=5.0)
            if (stop, thread, ring) in self._ring_workers:
                self._ring_workers.remove((stop, thread, ring))
            if thread.is_alive():
                # A wedged driver read outlived the join: freeing the
                # ring under the thread would be a use-after-free. Leak
                # it (bounded: depth * mtu) and say so.
                import logging

                logging.getLogger("airjax_torch").error(
                    "SDR rx thread did not stop within 5 s; leaking its "
                    "ring buffer instead of freeing it underneath"
                )
            else:
                ring.close()

    def close(self) -> None:
        # Ring rx threads first: a GIL-released readStream racing the
        # device free below is a use-after-free.
        for stop, thread, _ring in getattr(self, "_ring_workers", []):
            stop.set()
        for _stop, thread, _ring in getattr(self, "_ring_workers", []):
            thread.join(timeout=5.0)
        if any(t.is_alive() for _s, t, _r in getattr(self, "_ring_workers", [])):
            # Same rationale as the generator cleanup: never free the
            # device under a wedged reader. Leak it and report.
            import logging

            logging.getLogger("airjax_torch").error(
                "SDR rx thread still running after 5 s; leaking the "
                "device handle instead of freeing it underneath"
            )
            self._stream = None
            self._dev = None
            return
        if getattr(self, "_stream", None):
            self._lib.SoapySDRDevice_deactivateStream(self._dev, self._stream, 0, 0)
            self._lib.SoapySDRDevice_closeStream(self._dev, self._stream)
            self._stream = None
        if getattr(self, "_dev", None):
            self._lib.SoapySDRDevice_unmake(self._dev)
            self._dev = None
