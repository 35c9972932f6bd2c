"""The drive's hand-over stamps, on synthetic stamps and with no card: a
block is behind where the drive did not sleep for it or an earlier
block's message returned after its due time; drive_late_ms reads the
drive's own lateness; a live run's log line reads both beside the
latency from due."""

from __future__ import annotations

import re
import time
import types

import numpy as np
import pytest

from adsbench import harness
from adsbench.tests.conftest import REPO

PERIOD = 0.010
DUE = [PERIOD * j for j in range(4)]
# The drive woke 0.6, 0.4, 1.1 and 0.2 ms late.
RELEASED = [d + late for d, late in zip(DUE, (6e-4, 4e-4, 1.1e-3, 2e-4))]


def behind(slept, blocks, ends):
    return harness.behind_at_due(DUE, slept, blocks, ends).tolist()


def test_idle_blocks_are_not_behind():
    """Every block's messages returned 1.5 ms after its hand-over, long
    before the next was due: no block is behind."""
    blocks = np.array([0, 0, 1, 2, 3])
    assert behind([True] * 4, blocks, np.array([RELEASED[b] + 1.5e-3 for b in blocks])) == [False] * 4


def test_block_after_a_late_message_is_behind():
    """Block 1's last message returned after block 2 was due: block 2 is
    behind, blocks 1 and 3 are not."""
    blocks = np.array([0, 1, 1, 2, 3])
    ends = np.array([RELEASED[0] + 1e-3, RELEASED[1] + 2e-3, DUE[2] + 3e-4, DUE[2] + 5e-3, RELEASED[3] + 1e-3])
    assert behind([True] * 4, blocks, ends) == [False, False, True, False]


def test_warm_up_messages_count_for_the_first_block():
    """A warm-up message (block below 0) still in the sink when the first
    window block was due puts that block behind."""
    assert behind([True] * 4, np.array([-1, 1]), np.array([DUE[0] + 1e-4, RELEASED[1] + 1e-3]))[0]


def test_block_with_no_sleep_is_behind():
    """A drive behind its schedule slept for no block: each is behind,
    however early the program returned."""
    blocks = np.array([0, 1, 2, 3])
    assert behind([False] * 4, blocks, np.array([RELEASED[b] + 1e-3 for b in blocks])) == [True] * 4


def test_drive_late_reads_the_median_of_hand_over_less_due():
    reader = harness.Bench(REPO).reader("drive_late_ms.live")
    view = types.SimpleNamespace(drive_late_s=np.asarray(RELEASED) - np.asarray(DUE))
    assert reader.read(view) == pytest.approx(1e3 * np.median([6e-4, 4e-4, 1.1e-3, 2e-4]))
    assert reader.read(types.SimpleNamespace(drive_late_s=None)) is None


def test_open_drive_stamps_each_hand_over():
    """The drive stamps one hand-over a due block, never before it is due,
    and marks a block slept for exactly where it waited for it."""
    iq = np.zeros(100 * 8, np.int32)
    drive = harness.Drive(iq, 100, 1, 1e3, 0.45, lambda: None, lambda: None, lambda: None)
    n = sum(1 for _ in drive)
    assert n == 1 + len(drive.due) and len(drive.due) == len(drive.released) == len(drive.slept) == 5
    assert all(r >= d for r, d in zip(drive.released, drive.due))
    assert len(drive.waits) == sum(drive.slept)
    assert all(drive.released[j] >= drive.waits[sum(drive.slept[:j])][1]
               for j in range(5) if drive.slept[j])


def test_live_cell_reports_the_drive_and_the_blocks_behind(small_bench):
    """A small live cell's traced metrics hold drive_late_ms.live, and its
    log line the drive's lateness and the share of blocks behind at due."""
    r = harness.run_cell(small_bench, "web-df17.small.live", 2**35 + 11, 0.6, True, "cpu",
                         time.perf_counter())
    assert r["correct"], r["checks"]
    late = r["metrics"]["drive_late_ms.live"]["value"]
    assert late >= 0 and f"drive late median {late:.6f} ms" in r["log"][0]
    share = re.search(r"blocks behind at due (\d+) of (\d+), share ([0-9.]+)", r["log"][0])
    assert share and int(share[1]) <= int(share[2]) and float(share[3]) == pytest.approx(int(share[1]) / int(share[2]),
                                                                                         abs=1e-6)
