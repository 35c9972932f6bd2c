"""The port's pipeline configuration: airjax/config.py's `PipelineConfig`,
every field and property with airjax's defaults, redefined here so that
the port loads no module of airjax.

The reference scatters these constants across its files (gain 49.5
src/adsb.rs:27, 1090 MHz :42, 2 MS/s :44, derate 0.9
src/adsb/demod.rs:10, the 10 s CPR pair window src/adsb/aircraft.rs:68,
20,000-sample playback chunks src/adsb.rs:78); airjax gathers them in one
frozen dataclass. The port's decode paths read `block_len` and
`max_candidates`, and `adsb -m web` reads `web_host`; the other fields
record the reference's constants as airjax does. The framing fields and
their properties (`window_len` 240, `halo` 239) are the values the port's
modules hold as their own constants (dsp/demod.py `WINDOW`).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    # RF and sampling (reference src/adsb.rs:27, 42, 44).
    sample_rate_hz: float = 2_000_000.0
    center_freq_hz: float = 1_090_000_000.0
    gain_db: float = 49.5

    # Mode S framing (reference src/adsb/demod.rs:17-57, 65): 16
    # half-microsecond preamble samples, then 112 bits of 2 samples.
    preamble_samples: int = 16
    bits_per_frame: int = 112
    samples_per_bit: int = 2

    # Reference playback chunk size (src/adsb.rs:78); blocks are scanned at
    # stride 1 over offsets [0, block_len - window_len).
    block_len: int = 20000
    # Fixed per-block candidate capacity; detections past it set `overflow`
    # and the stream regrows the capacity.
    max_candidates: int = 256

    # The derate of the reference's dead threshold slicer
    # (src/adsb/demod.rs:10, 56; dsp/demod.py::threshold_slice_bits).
    high_threshold_derate: float = 0.9

    # Tracking: the CPR pair window (reference src/adsb/aircraft.rs:68, 84).
    cpr_pair_max_age_s: float = 10.0

    # Web display bind address and port (`adsb -m web`; src/adsb/web.rs:54).
    web_host: str = "127.0.0.1"
    web_port: int = 8080

    @property
    def frame_samples(self) -> int:
        """Samples of the 112 data bits (224)."""
        return self.bits_per_frame * self.samples_per_bit

    @property
    def window_len(self) -> int:
        """The detection window: preamble and data (240 samples)."""
        return self.preamble_samples + self.frame_samples

    @property
    def halo(self) -> int:
        """The overlap that keeps a window across a block edge (239)."""
        return self.window_len - 1

    @property
    def bytes_per_frame(self) -> int:
        return self.bits_per_frame // 8


DEFAULT_CONFIG = PipelineConfig()
