"""What reached the tracker over a run, kept small: a sink a packet adds
its 14 bytes and three stamps to flat arrays, and a sink a block keeps
only the rows its dict flagged. No block's dict, and no Python object a
packet, stays alive, so the record grows by some tens of bytes a packet
and the host's heap stays the size the program makes it."""

from __future__ import annotations

import array

import numpy as np

# The flags of an extended block's dict, and the columns kept of its
# flagged rows.
FLAG_KEYS = ("good_long", "good_df11", "cand_df11_ic", "cand_short_ap", "cand_long_ap")
ROW_KEYS = FLAG_KEYS + ("offsets", "frames", "frames_raw", "icao_ap_short", "icao_ap_long")


class Recorder:
    """Packets: frame bytes, the runner's dispatch stamp, the sink call's
    start and end. Blocks: the flagged rows of each block's dict, in the
    order the blocks came, with the messages applied and the call's start
    and end."""

    def __init__(self):
        self.frames = bytearray()
        self.stamps = array.array("d")
        self.starts = array.array("d")
        self.ends = array.array("d")
        self.blocks: list[tuple[dict, int]] = []
        self.block_starts = array.array("d")
        self.block_ends = array.array("d")

    def packet(self, frame: bytes, stamp: float, start: float, end: float) -> None:
        self.frames += frame
        self.stamps.append(stamp)
        self.starts.append(start)
        self.ends.append(end)

    def block(self, out: dict, applied: int, start: float, end: float) -> None:
        flags = [np.asarray(out[k]) for k in FLAG_KEYS]
        rows = np.flatnonzero(flags[0] | flags[1] | flags[2] | flags[3] | flags[4])
        self.blocks.append(({k: np.asarray(out[k])[rows] for k in ROW_KEYS}, int(applied)))
        self.block_starts.append(start)
        self.block_ends.append(end)

    @property
    def n_packets(self) -> int:
        return len(self.stamps)

    def packet_frames(self) -> list[bytes]:
        data = bytes(self.frames)
        return [data[i : i + 14] for i in range(0, len(data), 14)]

    def sink_spans(self) -> list[tuple[float, float]]:
        return list(zip(self.starts, self.ends)) + list(zip(self.block_starts, self.block_ends))
