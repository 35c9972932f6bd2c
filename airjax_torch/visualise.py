"""Debug plots and preamble dumps (airjax/visualise.py; it imports nothing
of jax, but the port keeps its own copy), which mirror src/visualise.rs and
the plot helper in src/adsb/demod.rs:209-244.

The reference renders bar plots of raw magnitudes around a detection to
SVG/PNG with `plotters` (unwired into its CLI). Here the same diagnostics
are wired into `adsb`: `--plot-dir DIR` dumps an SVG plot per decoded
frame (matplotlib, imported only then: a machine without it runs every
other path), `--dump-preamble` prints a text dump of each frame's preamble.
"""

from __future__ import annotations

import datetime
import os
import pathlib

import numpy as np


def plot_adsb_frame(
    mags: np.ndarray,
    out_dir: str | os.PathLike = ".",
    name: str | None = None,
    detection_offset: int | None = None,
    title: str = "ADSB Packet",
) -> str:
    """Bar-plot a magnitude window to an SVG file; returns the path.

    Mirrors plot_adsb_packet (demod.rs:209-244): timestamped filename,
    magnitude bars, y-limit 1.1x max.
    """
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    if name is None:
        name = datetime.datetime.now().strftime("adsb_packet_%Y%m%d_%H%M%S_%f.svg")
    path = pathlib.Path(out_dir) / name
    mags = np.asarray(mags)

    fig, ax = plt.subplots(figsize=(10, 4))
    ax.bar(np.arange(len(mags)), mags, width=1.0, color="tab:blue", alpha=0.6)
    if detection_offset is not None:
        ax.axvline(detection_offset, color="tab:red", lw=1, label="preamble start")
        ax.axvline(
            detection_offset + 16, color="tab:orange", lw=1, label="data start"
        )
        ax.legend(loc="upper right", fontsize=8)
    ax.set_ylim(0, max(float(mags.max()), 1.0) * 1.1)
    ax.set_title(title)
    ax.set_xlabel("sample")
    ax.set_ylabel("|IQ| (u32)")
    fig.tight_layout()
    fig.savefig(path)
    plt.close(fig)
    return str(path)


def format_preamble_ascii(mags: np.ndarray, threshold: float) -> str:
    """ASCII preamble sketch (mirrors visualise.rs:38-62 print helpers)."""
    mags = np.asarray(mags)[:16]
    marks = "".join("+" if m >= threshold else "-" for m in mags)
    ruler = "".join(str(i % 10) for i in range(len(mags)))
    return f"{marks}\n{ruler}"


def format_preamble(mags: np.ndarray) -> str:
    """Textual preamble dump: one row of the 16 preamble magnitudes, one
    row of sample indices, both center-padded to 5 like the reference's
    print_preamble (src/visualise.rs:38-50, its ' {:^5} ' format)."""
    mags = np.asarray(mags)[:16]
    values = "".join(f" {int(m):^5} " for m in mags)
    indices = "".join(f" {i:^5} " for i in range(len(mags)))
    return f"{values}\n{indices}"


_BLOCKS = "▁▂▃▄▅▆▇█"  # U+2581..U+2588, the ramp the reference started


def format_preamble_graph(mags: np.ndarray) -> str:
    """One-line block-character magnitude graph of the preamble — the
    completed form of the reference's stubbed print_preamble_graph
    (src/visualise.rs:53-62, which computes max_val then prints a single
    U+2581 and stops): each sample maps to one of 8 block heights
    scaled by the window maximum."""
    mags = np.asarray(mags, dtype=np.float64)[:16]
    peak = float(mags.max()) if len(mags) else 0.0
    if peak <= 0:
        return _BLOCKS[0] * len(mags)
    levels = np.minimum((mags / peak * 8).astype(int), 7)
    return "".join(_BLOCKS[lv] for lv in levels)


def dump_preamble(mags: np.ndarray, offset: int | None = None) -> str:
    """Full textual detection dump (`adsb --dump-preamble`): block graph
    + value/index table of the 16 preamble samples."""
    head = f"preamble @ {offset}\n" if offset is not None else ""
    return f"{head}{format_preamble_graph(mags)}\n{format_preamble(mags)}"
