"""The port's pipeline configuration: the fields of airjax/config.py's
`PipelineConfig` that the decode paths and the web display read, with the
same defaults. Redefined here so that the port loads no module of airjax."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    # Reference playback chunk size (src/adsb.rs:78); blocks are scanned at
    # stride 1 over offsets [0, block_len - window_len).
    block_len: int = 20000
    # Fixed per-block candidate capacity; detections past it set `overflow`
    # and the stream regrows the capacity.
    max_candidates: int = 256
    # Web display bind address (`adsb -m web`).
    web_host: str = "127.0.0.1"


DEFAULT_CONFIG = PipelineConfig()
