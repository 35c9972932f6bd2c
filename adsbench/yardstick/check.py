"""The comparison that decides `correct`: what the timed path emitted
against the plain reference, over the whole stream the run drove.

Each number compared is a count of disagreements, held to its limit in
LIMITS. The limits are 0: the comparison is exact (PERF.md gives the
readings of sound runs and of the control, the program's own parity
scan, from which they were set).

DF17 mode, a sink a packet (`packets`): the emitted packets' bytes in
stream order against the reference's frames; the packets grouped by the
dispatch stamp the runner gives each block against the reference's
frames grouped by the block that holds each frame's last window sample;
the runner's count of 1-bit repairs; the aircraft table (ICAOs,
callsigns, altitudes, positions).

Extended mode, a sink a block (`blocks`): every candidate the timed
decode flagged (global offset, kind, bytes, AP address or interrogator
code) against the reference's; the messages the sink applied against the
reference's pass-1 frames plus the AP-addressed candidates whose address
an earlier or the same block validated; the aircraft table: its ICAOs,
callsigns and positions, and for each aircraft of the sky its altitude,
squawk, ground speed, track and vertical rate, which the tracker takes
from the fields the card extracted (DF17 velocity, DF4/20 altitude, DF5
squawk).
"""

from __future__ import annotations

import collections

import numpy as np

from adsbench.yardstick import reference as ref

LIMITS = {
    "frames_failed": 0,
    "block_groups_failed": 0,
    "repairs_diff": 0,
    "table_failed": 0,
    "candidates_failed": 0,
    "applied_diff": 0,
}
# Two decodes of one pair agree to rounding; a pair of other frames moves
# the position by one CPR step (360 / 60 / 2^17 = 4.6e-5 degrees) or more.
POSITION_TOL_DEG = 1e-6
# Speeds and tracks are whole knots' hypot and atan2: two evaluations
# agree to rounding, and the next whole knot moves them 1e-3 or more.
SPEED_TOL = 1e-6
EXACT_FIELDS = ("altitude", "squawk", "vertical_rate_fpm")
FLOAT_FIELDS = ("ground_speed_kt", "track_deg")
HALO = ref.HALO


def multiset_diff(a: list, b: list) -> int:
    ca, cb = collections.Counter(a), collections.Counter(b)
    return sum(((ca - cb) + (cb - ca)).values())


def close(x, y, tol: float) -> bool:
    if x is None or y is None:
        return x is y
    return abs(x - y) <= tol


def row_differs(p: dict, e: dict, fields: tuple, callsign_if_known: bool) -> bool:
    if p["callsign"] != e["callsign"] and not (callsign_if_known and e["callsign"] is None):
        return True
    if any(p[k] != e[k] for k in fields if k in EXACT_FIELDS):
        return True
    if not all(close(p[k], e[k], SPEED_TOL) for k in fields if k in FLOAT_FIELDS):
        return True
    if p["position"] is None or e["position"] is None:
        return p["position"] is not e["position"]
    return max(abs(x - y) for x, y in zip(p["position"], e["position"])) > POSITION_TOL_DEG


def table_failed(program: dict, expected: dict, fields: tuple, callsign_if_known: bool,
                 more_fields: tuple = (), more_for: set = frozenset()) -> int:
    """Aircraft that only one table holds, or whose rows differ: in
    callsign and position, in `fields`, and for the aircraft `more_for`
    in `more_fields` too."""
    both = set(program) & set(expected)
    return len(set(program) ^ set(expected)) + sum(
        row_differs(program[i], expected[i], fields + (more_fields if i in more_for else ()), callsign_if_known)
        for i in both)


def stream_blocks(offsets: np.ndarray, block: int) -> np.ndarray:
    """The stream block that holds each window's last sample."""
    return (offsets + HALO) // block


def check_packets(rec, loop: dict, n_loop: int, n_stream: int, block: int, stats_repaired: int,
                  program_table: dict) -> tuple[dict, dict]:
    """DF17 mode. The recorder holds each packet's bytes and dispatch
    stamp in emission order -> (numbers compared, facts: the counts, and
    for the latency each message's stream block and sink call's return)."""
    exp = ref.over_stream(loop, n_loop, n_stream)
    want = [bytes(f) for f in exp["frames"]]
    got = rec.packet_frames()
    failed = multiset_diff(want, got)
    if failed == 0:
        failed = sum(a != b for a, b in zip(want, got))
    # Groups: the reference's frames by block, the emitted by stamp.
    blocks = stream_blocks(exp["offsets"], block)
    ref_blocks, ref_sizes = np.unique(blocks, return_counts=True)
    stamps = np.asarray(rec.stamps, np.float64)
    cut = np.nonzero(np.diff(stamps))[0] + 1 if len(stamps) else np.zeros(0, np.int64)
    got_sizes = np.diff(np.concatenate([[0], cut, [len(stamps)]])) if len(stamps) else np.zeros(0, np.int64)
    n = min(len(ref_sizes), len(got_sizes))
    groups_failed = int(np.sum(ref_sizes[:n] != got_sizes[:n])) + abs(len(ref_sizes) - len(got_sizes))
    expected_table = ref.table(exp["frames"])
    numbers = {
        "frames_failed": int(failed),
        "block_groups_failed": groups_failed,
        "repairs_diff": abs(int(stats_repaired) - int(exp["repaired"].sum())),
        "table_failed": table_failed(program_table, expected_table, ("altitude",), callsign_if_known=False),
    }
    # Each emitted packet's block, by the group it belongs to, and the
    # return of its sink call.
    packet_block = np.repeat(ref_blocks[:n], got_sizes[:n])
    facts = {"attempted": len(want), "failed": int(failed), "message_blocks": packet_block,
             "message_ends": np.asarray(rec.ends, np.float64)[: len(packet_block)]}
    return numbers, facts


def candidate_keys(rec, block: int, overlap: bool) -> tuple[list, list, int]:
    """The timed decode's flagged candidates, from the rows of the dicts a
    block sink received, as (global offset, kind, bytes, address) ->
    (keys, the sink call that received each, messages applied)."""
    keys, calls, applied = [], [], 0
    for i, (out, n_applied) in enumerate(rec.blocks):
        applied += int(n_applied)
        base = i * block - (HALO if overlap else 0)
        offs = np.asarray(out["offsets"]).astype(np.int64) + base
        flags = {
            ref.LONG: np.asarray(out["good_long"]),
            ref.DF11: np.asarray(out["good_df11"]),
            ref.DF11_IC: np.asarray(out["cand_df11_ic"]),
            ref.SHORT_AP: np.asarray(out["cand_short_ap"]),
            ref.LONG_AP: np.asarray(out["cand_long_ap"]),
        }
        frames = np.asarray(out["frames"])
        raw = np.asarray(out["frames_raw"])
        ap_s, ap_l = np.asarray(out["icao_ap_short"]), np.asarray(out["icao_ap_long"])
        for kind, mask in flags.items():
            for k in np.nonzero(mask.astype(bool) & (offs >= 0))[0].tolist():
                if kind == ref.LONG:
                    fb, addr = bytes(frames[k]), 0
                elif kind == ref.DF11:
                    fb, addr = bytes(raw[k][:7]) + bytes(7), 0
                elif kind == ref.LONG_AP:
                    fb, addr = bytes(raw[k]), int(ap_l[k])
                else:
                    fb, addr = bytes(raw[k][:7]) + bytes(7), int(ap_s[k])
                keys.append((int(offs[k]), kind, fb, addr))
                calls.append(i)
    return keys, calls, applied


def taken(exp: dict, block: int) -> np.ndarray:
    """(n,) bool: what the tracker takes. Pass-1 frames (the validated
    long squitters and DF11s), and the AP-addressed and interrogated DF11
    candidates whose address the stream validated in the same block or
    before."""
    kinds, offs, frames, addr = exp["kinds"], exp["offsets"], exp["frames"], exp["address"]
    blocks = stream_blocks(offs, block)
    icao = (frames[:, 1].astype(np.int64) << 16) | (frames[:, 2].astype(np.int64) << 8) | frames[:, 3]
    pass1 = (kinds == ref.LONG) | (kinds == ref.DF11)
    first_seen: dict[int, int] = {}
    for ic, b in zip(icao[pass1].tolist(), blocks[pass1].tolist()):
        first_seen.setdefault(ic, b)
    gated = np.nonzero(~pass1)[0]
    ap = np.where(kinds[gated] == ref.DF11_IC, icao[gated], addr[gated])
    ok = [first_seen.get(a, 1 << 62) <= b for a, b in zip(ap.tolist(), blocks[gated].tolist())]
    out = pass1.copy()
    out[gated] = ok
    return out


def check_blocks(rec, loop: dict, n_loop: int, n_stream: int, block: int, program_table: dict,
                 aircraft: set, overlap: bool = True) -> tuple[dict, dict]:
    """Extended mode, a sink a block -> (numbers compared, facts, as
    check_packets gives them). `aircraft`: the sky's addresses, whose fields are compared."""
    exp = ref.over_stream(loop, n_loop, n_stream)
    want = [(int(o), int(k), bytes(f), int(a)) for o, k, f, a in
            zip(exp["offsets"], exp["kinds"], exp["frames"], exp["address"])]
    got, calls, applied = candidate_keys(rec, block, overlap)
    failed = multiset_diff(want, got)
    take = taken(exp, block)
    # For the latency: each message the tracker took, by the block sink
    # call that received its candidate.
    call_of = {key[:2]: i for key, i in zip(got, calls)}
    took = [(call_of.get((o, k)), b) for o, k, b in
            zip(exp["offsets"][take].tolist(), exp["kinds"][take].tolist(),
                stream_blocks(exp["offsets"][take], block).tolist())]
    took = [(i, b) for i, b in took if i is not None]
    block_ends = np.asarray(rec.block_ends, np.float64)
    expected_table = ref.table(exp["frames"][take], exp["kinds"][take], exp["address"][take])
    numbers = {
        "candidates_failed": int(failed),
        "applied_diff": abs(applied - int(take.sum())),
        "table_failed": table_failed(program_table, expected_table, (), callsign_if_known=True,
                                     more_fields=EXACT_FIELDS + FLOAT_FIELDS, more_for=aircraft),
    }
    return numbers, {"attempted": len(want), "failed": int(failed),
                     "message_blocks": np.asarray([b for _, b in took], np.int64),
                     "message_ends": block_ends[np.asarray([i for i, _ in took], np.int64)]}


def verdict(numbers: dict) -> bool:
    return all(v <= LIMITS[k] for k, v in numbers.items())
