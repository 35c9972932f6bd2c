"""Stream display: one line per decoded frame, the first line of the
reference Display (airjax/protocol/packet.py:800 prints `== <hex> ==`).
Parsing frames into packets waits for a jax-free airjax host tier."""

from __future__ import annotations

import sys

from airjax_torch.runner import Frame


def stream_printer(out=None):
    out = out or sys.stdout

    def on_frame(frame: Frame) -> None:
        out.write(f"\n== {frame.data.hex()} ==\n")
        out.flush()

    return on_frame
