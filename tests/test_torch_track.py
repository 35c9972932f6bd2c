"""airjax_torch's trackers against airjax's, on the same frames, packets
and `now` values: CPR (scalar and batched), the per-packet Aircraft table
(surface positions with a receiver position, eviction), BatchTracker and
ExtendedBatchTracker (fed by each package's own decode and fields, with
and without recover2), the state checkpoint read across packages, and
run_stream's packets, StreamStats and tables for every sink x extended x
recover2. Inputs are made with numpy from seeds; the trackers' tables
compare exactly, floats included (both run the same numpy and math)."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from airjax import extended as jext
from airjax import pipeline as jpipe
from airjax import runner as jrunner
from airjax.protocol import fields as jfields
from airjax.protocol.packet import AdsbPacket as JPacket
from airjax.track import aircraft as jair
from airjax.track import batch as jbatch
from airjax.track import cpr as jcpr
from airjax.track import cpr_batch as jcpr_batch
from airjax.track import state as jstate
from airjax.track.icao_cache import IcaoCache as JCache
from airjax_torch import cli
from airjax_torch import extended as text
from airjax_torch import pipeline as tpipe
from airjax_torch import runner as trunner
from airjax_torch.io import synth
from airjax_torch.protocol import fields as tfields
from airjax_torch.protocol import shortframe
from airjax_torch.protocol.packet import AdsbPacket as TPacket
from airjax_torch.protocol.packet import CprFormat as TCpr
from airjax_torch.track import aircraft as tair
from airjax_torch.track import batch as tbatch
from airjax_torch.track import cpr as tcpr
from airjax_torch.track import cpr_batch as tcpr_batch
from airjax_torch.track import state as tstate
from airjax_torch.runner import StreamStats
from airjax_torch.track.icao_cache import IcaoCache as TCache
from airjax_torch.ui.web import WebDisplay
from torch_parity import packet_fields

ICAOS = [0x7C6B30, 0x40621D, 0xABCDEF, 0x111111, 0x0F00BA]
REF_POS = (-41.3, 174.8)
N = 12000
CAP = 256
SYNTH_T_MAX = 1e9  # block times below this; Aircraft() defaults are wall clock

_ATTRS = (
    "callsign", "altitude", "on_ground", "ground_speed_kt", "track_deg", "vertical_rate_fpm", "squawk",
    "emergency_state", "adsb_version", "selected_altitude_ft", "selected_heading_deg", "acas_ra",
    "bds_candidates", "gicb_supported", "commd_segments", "commd_elm", "met",
)


def _stash(s):
    """A CPR stash of either package or path: (lat, lon), or the
    message's dataclass fields."""
    if s is None or isinstance(s, tuple):
        return None if s is None else tuple(s)
    return packet_fields(s)


def state(aircrafts: dict) -> dict:
    """An aircraft table of either package, comparable: every attribute,
    the stashes, the position, the summary, and the times that a block set
    (an untouched default is wall clock)."""
    out = {}
    for icao, a in aircrafts.items():
        d = {attr: getattr(a, attr) for attr in _ATTRS}
        d["geo"] = None if a.geo_position is None else (a.geo_position.latitude, a.geo_position.longitude)
        for attr in ("last_even_packet", "last_odd_packet", "last_even_surface", "last_odd_surface"):
            d[attr] = _stash(getattr(a, attr))
        for attr in ("last_contact", "last_even_processed", "last_odd_processed", "last_even_surface_t",
                     "last_odd_surface_t"):
            t = getattr(a, attr)
            d[attr] = t if t < SYNTH_T_MAX else "wall"
        summary = a.get_summary().to_json(extended=True)
        summary["lastContact"] = d["last_contact"]
        d["summary"] = summary
        out[icao] = d
    return out


# ---------------------------------------------------------------------------
# CPR


def test_cpr_scalar_equals_airjax():
    rng = np.random.default_rng(0)
    lats = np.concatenate([[0.0, 87.0, -87.0, 87.5, -90.0, 10.47047130, -10.47047130],
                           rng.uniform(-90, 90, 500)])
    assert [tcpr.calc_num_zones(float(x)) for x in lats] == [jcpr.calc_num_zones(float(x)) for x in lats]
    for _ in range(400):
        e = (int(rng.integers(0, 1 << 17)), int(rng.integers(0, 1 << 17)))
        o = (int(rng.integers(0, 1 << 17)), int(rng.integers(0, 1 << 17)))
        for first in ("EVEN", "ODD"):
            t = tcpr.calculate_geographic_position(e, o, TCpr[first])
            j = jcpr.calculate_geographic_position(e, o, jcpr.CprFormat[first])
            assert (t is None and j is None) or (t.latitude, t.longitude) == (j.latitude, j.longitude)
            ref = (float(rng.uniform(-89, 89)), float(rng.uniform(-180, 180)))
            t = tcpr.calculate_surface_position(e, o, TCpr[first], *ref)
            j = jcpr.calculate_surface_position(e, o, jcpr.CprFormat[first], *ref)
            assert (t is None and j is None) or (t.latitude, t.longitude) == (j.latitude, j.longitude)


def test_cpr_batch_equals_airjax():
    rng = np.random.default_rng(1)
    n = 5000
    args = [rng.integers(0, 1 << 17, n) for _ in range(4)] + [rng.integers(0, 2, n).astype(bool)]
    for want, got in zip(jcpr_batch.decode_pairs(*args), tcpr_batch.decode_pairs(*args)):
        assert want.dtype == got.dtype
        np.testing.assert_array_equal(want, got)
    lats = np.concatenate([[0.0, 87.0, -87.0, 88.0], rng.uniform(-90, 90, 1000)])
    np.testing.assert_array_equal(jcpr_batch.calc_num_zones_batch(lats), tcpr_batch.calc_num_zones_batch(lats))


# ---------------------------------------------------------------------------
# Frames for the trackers


def _random_frame(rng) -> bytes:
    """One frame of any class the trackers handle (as airjax's
    tests/test_batch_extended.py draws them)."""
    icao = ICAOS[rng.integers(len(ICAOS))]
    kind = int(rng.integers(0, 15))
    if kind == 0:
        return synth.make_df17(icao, synth.make_id_me("".join(chr(65 + rng.integers(26)) for _ in range(6))))
    if kind in (1, 2):
        return synth.make_df17(icao, synth.make_position_me(
            int(rng.integers(9, 19)), int(rng.integers(0, 1600)) * 25 - 1000, int(rng.integers(0, 1 << 17)),
            int(rng.integers(0, 1 << 17)), bool(rng.integers(2))))
    if kind in (3, 4):
        return synth.make_df17(icao, synth.make_velocity_me(
            ew_kt=int(rng.integers(-300, 301)), ns_kt=int(rng.integers(-300, 301)),
            vertical_rate_fpm=None if rng.random() < 0.3 else int(rng.integers(-80, 81)) * 64,
            subtype=int(rng.choice([1, 1, 2, 3, 4])),
            heading_deg=None if rng.random() < 0.3 else float(rng.integers(0, 360)),
            airspeed_kt=int(rng.integers(0, 500))))
    if kind == 5:
        me = [synth.make_id_me("TISB"), synth.make_position_me(11, 5000, 93000, 51372, False),
              synth.make_velocity_me(ew_kt=100, ns_kt=-50, vertical_rate_fpm=640)][rng.integers(3)]
        return synth.make_df18(icao, me, cf=int(rng.integers(0, 8)))
    if kind == 6:
        return synth.make_df17(icao, synth.make_surface_me(
            REF_POS[0] + float(rng.uniform(-0.2, 0.2)), REF_POS[1] + float(rng.uniform(-0.2, 0.2)),
            odd=bool(rng.integers(2)), tc=int(rng.integers(5, 9)), speed_kt=float(rng.integers(0, 60)),
            track_deg=float(rng.integers(0, 360))))
    if kind == 7:
        sel = rng.integers(4)
        me = (synth.make_status_me(int("".join(str(rng.integers(0, 8)) for _ in range(4)))) if sel == 0
              else synth.make_opstatus_me() if sel == 1
              else synth.make_target_state_me(int(rng.integers(0, 1000)) * 32, selected_heading_deg=90.0) if sel == 2
              else bytes([0, 0, int(rng.integers(0, 256)), 0, 0, 0, 0]))
        return synth.make_df17(icao, me)
    if kind == 8:
        return shortframe.make_df11(icao, interrogator=int(rng.integers(1, 16)) if rng.random() < 0.5 else 0)
    alt = int(rng.integers(0, 2000)) * 25 - 1000
    squawk = int("".join(str(rng.integers(0, 8)) for _ in range(4)))
    if kind == 9:
        return shortframe.make_df0(icao, alt, vs=int(rng.integers(0, 2)))
    if kind == 10:
        return shortframe.make_df16(icao, alt)
    if kind == 11:
        return shortframe.make_df4(icao, alt, fs=int(rng.integers(0, 6)))
    if kind == 12:
        return shortframe.make_df5(icao, squawk)
    if kind == 13:
        return shortframe.make_df20(icao, alt) if rng.random() < 0.5 else shortframe.make_df21(icao, squawk)
    return shortframe.make_df24(icao, nd=int(rng.integers(0, 16)), md=bytes(rng.integers(0, 256, 10, dtype=np.uint8)),
                                ke=int(rng.integers(0, 2)))


def _random_capture(rng) -> np.ndarray:
    frames, offsets = [], []
    for _ in range(int(rng.integers(2, 9))):
        frame = _random_frame(rng)
        r = rng.random()
        if r < 0.15:  # 1-bit corruption: repair and AP interplay
            frame = synth.flip_bit(frame, int(rng.integers(0, 8 * len(frame))))
        elif r < 0.3 and len(frame) == 14:  # 2-bit corruption: recover2's gate
            frame = synth.flip_bit(synth.flip_bit(frame, int(rng.integers(5, 48))), int(rng.integers(48, 88)))
        frames.append(frame)
        offsets.append(int(rng.integers(0, N - 600)))
    return synth.modulate(frames, offsets, N, noise_std=float(rng.uniform(10, 120)), seed=int(rng.integers(0, 1 << 31)))


# ---------------------------------------------------------------------------
# Per-packet Aircraft table


@pytest.mark.parametrize("seed", [0, 1])
def test_per_packet_table_equals_airjax(seed):
    """Aircraft.handle_packet / handle_aircraft_update / handle_extended_update
    (surface positions with ref_position), and evict_stale."""
    rng = np.random.default_rng(seed)
    per_t, per_j = {}, {}
    t = 1000.0
    for block in range(10):
        t += float(rng.choice([0.5, 3.0, 11.0, 61.0]))
        out_j = jax.device_get(jpipe.decode_iq_block_extended(jnp.asarray(_random_capture(rng)), N - 240, CAP))
        for off, p in jext.assemble_extended(out_j, t, JCache()):
            jext.handle_extended_update(p, per_j, ref_position=REF_POS)
        out_t = {k: np.asarray(v) for k, v in out_j.items()}
        for off, p in text.assemble_extended(out_t, t, TCache()):
            text.handle_extended_update(p, per_t, ref_position=REF_POS)
        assert state(per_t) == state(per_j)
        if block == 5:
            assert tair.evict_stale(per_t, 30.0, now=t) == jair.evict_stale(per_j, 30.0, now=t)
    assert len(per_t) >= 3
    # The DF17 path of the reference: handle_aircraft_update with a packet each.
    frames = [_random_frame(rng) for _ in range(300)]
    frames = [f for f in frames if f[0] >> 3 == 17]
    tab_t, tab_j = {}, {}
    for i, f in enumerate(frames):
        tair.handle_aircraft_update(TPacket.from_bytes(f, 100.0 + i), tab_t, ref_position=REF_POS)
        jair.handle_aircraft_update(JPacket.from_bytes(f, 100.0 + i), tab_j, ref_position=REF_POS)
    assert state(tab_t) == state(tab_j)


# ---------------------------------------------------------------------------
# Batched trackers


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_batch_tracker_equals_airjax(seed):
    """BatchTracker.on_fields with the port's fields against airjax's with
    its own, and against the port's per-packet table."""
    rng = np.random.default_rng(seed)
    bt_t, bt_j = tbatch.BatchTracker(), jbatch.BatchTracker()
    per = {}
    t = 1000.0
    for _ in range(12):
        t += float(rng.choice([0.5, 3.0, 11.0]))
        frames = []
        for _ in range(int(rng.integers(1, 30))):
            f = _random_frame(rng)
            frames.append(f if len(f) == 14 else f + bytes(7))
        arr = np.frombuffer(b"".join(frames), np.uint8).reshape(len(frames), 14).copy()
        f_t = tpipe.to_host(tfields.extract_fields(torch.as_tensor(arr)))
        f_j = jax.device_get(jfields.extract_fields(jnp.asarray(arr)))
        idx = np.nonzero(f_j["df"] == 17)[0]
        assert bt_t.on_fields(f_t, idx, t) == bt_j.on_fields(f_j, idx, t) == len(idx)
        for k in idx:
            tair.handle_aircraft_update(TPacket.from_bytes(frames[k], t), per)
        assert state(bt_t.aircrafts) == state(bt_j.aircrafts)
    assert bt_t.n_messages == bt_j.n_messages
    # The per-packet table stashes messages where the batched one stashes
    # pairs; everything else is the same.
    norm = {ic: {k: v for k, v in d.items() if not k.startswith("last_") or k == "last_contact"}
            for ic, d in state(per).items()}
    assert norm == {ic: {k: v for k, v in d.items() if not k.startswith("last_") or k == "last_contact"}
                    for ic, d in state(bt_t.aircrafts).items()}


@pytest.mark.parametrize("recover2", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_extended_batch_tracker_equals_airjax(seed, recover2):
    """ExtendedBatchTracker.on_extended_block on each package's own
    decode_iq_block_extended_with_fields: the tables, the ICAO caches and
    the counts applied equal, block after block (recover2: pass 1.5)."""
    rng = np.random.default_rng(seed)
    bt_t, bt_j = tbatch.ExtendedBatchTracker(ref_position=REF_POS), jbatch.ExtendedBatchTracker(ref_position=REF_POS)
    cache_t, cache_j = TCache(), JCache()
    t = 1000.0
    for block in range(8):
        t += float(rng.choice([0.5, 3.0, 11.0, 61.0]))
        iq = _random_capture(rng)
        out_j = jax.device_get(jpipe.decode_iq_block_extended_with_fields(jnp.asarray(iq), N - 240, CAP, recover2))
        out_t = tpipe.to_host(tpipe.decode_iq_block_extended_with_fields(torch.as_tensor(iq), N - 240, CAP, recover2))
        min_offset = 300 if block == 0 else None
        applied_j = bt_j.on_extended_block(out_j, t, cache_j, min_offset=min_offset)
        assert bt_t.on_extended_block(out_t, t, cache_t, min_offset=min_offset) == applied_j
        assert cache_t._seen == cache_j._seen
        assert state(bt_t.aircrafts) == state(bt_j.aircrafts)
    assert bt_t.n_messages == bt_j.n_messages > 0


# Addresses of the inline blocks: many aircraft, so that a block leaves
# many ground speeds and tracks to compare.
INLINE_ICAOS = [0x3C0000 + 0x1357 * k for k in range(48)]


def _inline_frame(rng) -> bytes:
    """One frame of a kind the row pass applies inline: a DF17 identity,
    airborne position or TC19 velocity, a DF11 all-call (a share
    interrogated), a DF4, DF5 or DF0 reply."""
    icao = INLINE_ICAOS[rng.integers(len(INLINE_ICAOS))]
    kind = int(rng.integers(0, 8))
    if kind == 0:
        return synth.make_df17(icao, synth.make_id_me("".join(chr(65 + rng.integers(26)) for _ in range(6))))
    if kind in (1, 2):
        return synth.make_df17(icao, synth.make_position_me(
            11, int(rng.integers(0, 1600)) * 25 - 1000, int(rng.integers(0, 1 << 17)), int(rng.integers(0, 1 << 17)),
            bool(rng.integers(2))))
    if kind in (3, 4):
        return synth.make_df17(icao, synth.make_velocity_me(
            ew_kt=int(rng.integers(-300, 301)), ns_kt=int(rng.integers(-300, 301)),
            vertical_rate_fpm=None if rng.random() < 0.3 else int(rng.integers(-80, 81)) * 64,
            subtype=int(rng.choice([1, 1, 2]))))
    if kind == 5:
        return shortframe.make_df11(icao, interrogator=int(rng.integers(1, 16)) if rng.random() < 0.3 else 0)
    alt = int(rng.integers(0, 2000)) * 25 - 1000
    if kind == 6:
        return shortframe.make_df4(icao, alt) if rng.random() < 0.5 else shortframe.make_df0(icao, alt, vs=int(rng.integers(2)))
    return shortframe.make_df5(icao, int("".join(str(rng.integers(0, 8)) for _ in range(4))))


def _spaced_capture(rng, frames: list[bytes], n: int) -> np.ndarray:
    """`frames` at random 260-sample slots of an n-sample capture (no two
    overlap), a share of the long ones with one bit flipped: bit 3 in some,
    which turns DF17 into DF19 until the repair turns it back."""
    slots = np.sort(rng.choice((n - 600) // 260, len(frames), replace=False)) * 260 + 100
    frames = [synth.flip_bit(f, 3 if rng.random() < 0.5 else int(rng.integers(0, 112)))
              if len(f) == 14 and rng.random() < 0.2 else f for f in frames]
    return synth.modulate(frames, slots.tolist(), n, noise_std=float(rng.uniform(10, 80)),
                          seed=int(rng.integers(0, 1 << 31)))


def _like_per_packet(table: dict) -> dict:
    """state() with each CPR stash as its (lat, lon) and the velocity
    floats rounded to 1e-9: the per-packet path stashes messages and takes
    ground speed and track from math.*, the batched one (without a row of
    the per-packet path) from numpy."""
    out = state(table)
    for d in out.values():
        for key in ("last_even_packet", "last_odd_packet"):
            v = d[key]
            if v is not None and isinstance(v[1], dict):
                d[key] = (v[1]["cpr_latitude"], v[1]["cpr_longitude"])
        for key in ("ground_speed_kt", "track_deg"):
            if d[key] is not None:
                d[key] = round(d[key], 9)
        d["summary"] = {k: round(v, 9) if isinstance(v, float) else v for k, v in d["summary"].items()}
    return out


def _permuted(out: dict, order: np.ndarray) -> dict:
    """A decode dict with its slots, in every slot-wide array, put in
    `order`: its offsets no longer ascend."""
    return {key: _permuted(v, order) if isinstance(v, dict) else v[order] if np.ndim(v) and len(v) == len(order) else v
            for key, v in out.items()}


ROW_PASS_CASES = ("inline", "mixed", "min_offset", "recover2", "bulk", "unordered", "oracle")


@pytest.mark.parametrize("case", ROW_PASS_CASES)
def test_extended_row_pass_equals_airjax_and_per_packet(case, monkeypatch):
    """ExtendedBatchTracker's row pass against airjax's tracker, exactly,
    and against the per-packet path (assemble_extended +
    handle_extended_update), block after block on the port's dicts: blocks
    of inline kinds only (ground speed and track then take airjax's numpy
    expression), blocks with rows of the per-packet path, min_offset,
    recover2, calls of hundreds of rows (`bulk`, as a whole capture's),
    slots out of offset order (`unordered`) and blocks without
    `short_fields` (`oracle`: the host decodes the candidates' fields).
    The selected slots come in ascending offset order; the counters count
    the blocks and the rows that took the per-packet path."""
    rng = np.random.default_rng(10 + ROW_PASS_CASES.index(case))
    recover2 = case == "recover2"
    bt_t, bt_j = tbatch.ExtendedBatchTracker(ref_position=REF_POS), jbatch.ExtendedBatchTracker(ref_position=REF_POS)
    cache_t, cache_j, cache_p = TCache(), JCache(), TCache()
    per: dict = {}
    per_packet_rows = []
    apply_fallback = tbatch.BatchTracker._apply_fallback
    monkeypatch.setattr(tbatch.BatchTracker, "_apply_fallback",
                        lambda self, pkt, *a: (per_packet_rows.append(pkt), apply_fallback(self, pkt, *a)))
    n_blocks = 2 if case == "bulk" else 6
    t = 1000.0
    for block in range(n_blocks):
        t += float(rng.choice([0.5, 3.0, 11.0, 61.0]))
        if case == "bulk":
            n, cap = 260 * 316, 1024
            iq = _spaced_capture(rng, [_inline_frame(rng) for _ in range(300)], n)
        elif case == "inline":
            n, cap = N, CAP
            iq = _spaced_capture(rng, [_inline_frame(rng) for _ in range(int(rng.integers(20, 40)))], n)
        else:
            n, cap = N, CAP
            iq = _random_capture(rng)
        out = tpipe.to_host(tpipe.decode_iq_block_extended_with_fields(torch.as_tensor(iq), n - 240, cap, recover2))
        union = out["good_long"] | out["good_df11"] | out["cand_df11_ic"] | out["cand_short_ap"] | out["cand_long_ap"]
        offsets = out["offsets"][np.nonzero(union)[0]]
        assert np.all(offsets[1:] > offsets[:-1])
        if case == "unordered":
            out = _permuted(out, rng.permutation(len(out["offsets"])))
        elif case == "oracle":
            del out["short_fields"]
        assert out["offsets"][tbatch.select_rows(out)].tolist() == offsets.tolist()
        min_offset = int(rng.integers(500, 6000)) if case == "min_offset" else None
        applied = bt_t.on_extended_block(out, t, cache_t, min_offset=min_offset)
        assert applied == bt_j.on_extended_block(out, t, cache_j, min_offset=min_offset)
        assert cache_t._seen == cache_j._seen
        assert state(bt_t.aircrafts) == state(bt_j.aircrafts)
        packets = [p for off, p in text.assemble_extended(out, t, cache_p) if min_offset is None or off >= min_offset]
        for p in packets:
            text.handle_extended_update(p, per, ref_position=REF_POS)
        assert applied == len(packets)
        assert cache_t._seen == cache_p._seen
        assert _like_per_packet(bt_t.aircrafts) == _like_per_packet(per)
    assert bt_t.n_messages > 0
    assert bt_t.blocks == n_blocks and bt_t.fallback_rows == len(per_packet_rows)
    assert (bt_t.fallback_rows == 0) == (case in ("inline", "bulk"))
    if case == "inline":
        assert any(a.ground_speed_kt is not None for a in bt_t.aircrafts.values())
        line = cli._stats_line(StreamStats(), WebDisplay(quiet=True), bt_t)
        assert list(line)[-4:] == ["summaries_sent", "summaries_dropped", "batched_blocks", "fallback_rows"]
        assert (line["batched_blocks"], line["fallback_rows"]) == (n_blocks, 0)


def test_split_ap_candidates_and_elm_equal_airjax():
    rng = np.random.default_rng(4)
    for _ in range(6):
        iq = _random_capture(rng)
        out_j = jax.device_get(jpipe.decode_iq_block_extended_with_fields(jnp.asarray(iq), N - 240, CAP))
        out_t = tpipe.to_host(tpipe.decode_iq_block_extended_with_fields(torch.as_tensor(iq), N - 240, CAP))
        cache_j, cache_t = JCache(), TCache()
        for ic in ICAOS:
            cache_j.add(ic, 10.0)
            cache_t.add(ic, 10.0)
        for use_fields in (True, False):
            oj, ot = dict(out_j), dict(out_t)
            if not use_fields:
                oj.pop("short_fields"), ot.pop("short_fields")
            simple_j, complex_j = jext.split_ap_candidates(oj, 10.0, cache_j, min_offset=100)
            simple_t, complex_t = text.split_ap_candidates(ot, 10.0, cache_t, min_offset=100)
            assert sorted(simple_j) == sorted(simple_t)
            for key in simple_j:
                assert simple_j[key].dtype == simple_t[key].dtype
                np.testing.assert_array_equal(simple_j[key], simple_t[key])
            assert [(o, packet_fields(p)) for o, p in complex_t] == [(o, packet_fields(p)) for o, p in complex_j]
    segments = {"0": "00" * 10, "1": "20" + "11" * 9, "3": "ff" * 10}
    assert text.assemble_elm(segments) == jext.assemble_elm(segments) is None
    del segments["3"]
    payload = text.assemble_elm(segments)
    assert payload == jext.assemble_elm(segments) and len(payload) == 20
    assert text.assemble_elm(segments, expected_segments=3) is None
    for p in (payload, bytes(range(14)), synth.make_id_me("ELM1") + bytes(3)):
        assert text.interpret_elm(p) == jext.interpret_elm(p)
        assert text.interpret_elm(p, gicb_supported=["2,0"]) == jext.interpret_elm(p, gicb_supported=["2,0"])


# ---------------------------------------------------------------------------
# Checkpoints


def test_state_round_trips_across_packages(tmp_path):
    rng = np.random.default_rng(6)
    per_t, bt = {}, tbatch.ExtendedBatchTracker(ref_position=REF_POS)
    cache = TCache()
    for i in range(6):
        out = tpipe.to_host(tpipe.decode_iq_block_extended_with_fields(torch.as_tensor(_random_capture(rng)),
                                                                       N - 240, CAP))
        for _, p in text.assemble_extended(out, 100.0 + i, TCache()):
            text.handle_extended_update(p, per_t, ref_position=REF_POS)
        bt.on_extended_block(out, 100.0 + i, cache)
    for table in (per_t, bt.aircrafts):
        assert table
        tstate.save_state(table, tmp_path / "t.json")
        restored_j = jstate.load_state(tmp_path / "t.json")
        assert state(restored_j) == state(table)
        jstate.save_state(restored_j, tmp_path / "j.json")
        assert (tmp_path / "j.json").read_text() == (tmp_path / "t.json").read_text()
        assert state(tstate.load_state(tmp_path / "j.json")) == state(table)
    (tmp_path / "bad.json").write_text('{"version": 99, "aircraft": []}')
    with pytest.raises(ValueError):
        tstate.load_state(tmp_path / "bad.json")


# ---------------------------------------------------------------------------
# run_stream, every sink


def _stream_iq(seed: int) -> np.ndarray:
    """Two aircraft over 100,000 samples: positions, IDs, velocities, short
    replies, 1- and 2-bit corruption (a 2-flip of an unseen aircraft too)."""
    rng = np.random.default_rng(seed)
    frames, offs = [], []
    for i in range(40):
        icao = ICAOS[i % 2] if i % 13 else 0x123456
        lat, lon = synth.encode_airborne_cpr(52.0 + i / 100, 4.0 + i / 50, bool(i % 2))
        f = [synth.make_df17(icao, synth.make_position_me(11, 30000 + 25 * i, lat, lon, bool(i % 2))),
             synth.make_df17(icao, synth.make_id_me(f"STR{i % 2}")),
             synth.make_df17(icao, synth.make_velocity_me(100, -40, 128)),
             shortframe.make_df4(icao, 30000), shortframe.make_df11(icao)][i % 5]
        if i % 7 == 3 and len(f) == 14:
            f = synth.flip_bit(f, int(rng.integers(5, 88)))
        elif i % 7 == 5 and len(f) == 14:
            f = synth.flip_bit(synth.flip_bit(f, int(rng.integers(5, 40))), int(rng.integers(40, 88)))
        frames.append(f)
        offs.append(1000 + 2450 * i)
    return synth.modulate(frames, offs, 100_000, seed=seed)


def _untimed(packet) -> tuple:
    name, fields = packet_fields(packet)
    fields.pop("time_processed")
    return name, fields


def _sinks(kind: str, extended: bool):
    """(port sink, airjax sink, port table, airjax table or packet lists)."""
    if kind == "packets":
        got, want = [], []
        return got.append, want.append, got, want
    if kind == "table":
        tab_t, tab_j = {}, {}
        if extended:
            return (lambda p: text.handle_extended_update(p, tab_t), lambda p: jext.handle_extended_update(p, tab_j),
                    tab_t, tab_j)
        return (lambda p: tair.handle_aircraft_update(p, tab_t), lambda p: jair.handle_aircraft_update(p, tab_j),
                tab_t, tab_j)
    t_cls = tbatch.ExtendedBatchTracker if extended else tbatch.BatchTracker
    j_cls = jbatch.ExtendedBatchTracker if extended else jbatch.BatchTracker
    bt_t, bt_j = t_cls(), j_cls()
    return bt_t, bt_j, bt_t.aircrafts, bt_j.aircrafts


@pytest.mark.parametrize("recover2", [False, True])
@pytest.mark.parametrize("extended", [False, True])
@pytest.mark.parametrize("kind", ["packets", "table", "batched"])
def test_run_stream_every_sink_equals_airjax(kind, extended, recover2):
    iq = _stream_iq(3)
    blocks = [iq[i : i + 20000] for i in range(0, len(iq), 20000)]
    sink_t, sink_j, res_t, res_j = _sinks(kind, extended)
    s_t = trunner.run_stream(iter(blocks), sink_t, extended=extended, recover2=recover2, device="cpu").as_dict()
    s_j = jrunner.run_stream(iter(blocks), sink_j, extended=extended, recover2=recover2).as_dict()
    for d in (s_t, s_j):
        d.pop("msamples_per_s"), d.pop("stages")
    assert s_t == s_j
    assert s_t["good"] > 20
    if kind == "packets":
        # `now` is the wall clock of each run's dispatch.
        assert [_untimed(p) for p in res_t] == [_untimed(p) for p in res_j]
    else:
        assert state(res_t) == state(res_j)
    if recover2 and not (extended and kind == "batched"):
        assert s_t["recovered2"] > 0
    if extended and kind == "batched":
        assert s_t["recovered2"] == 0  # airjax's extended batched sink never counts them


def test_gate_recover2_batch_equals_airjax():
    rng = np.random.default_rng(8)
    seen_t, seen_j = set(), set()
    for _ in range(20):
        n = int(rng.integers(0, 12))
        idx = np.sort(rng.choice(40, n, replace=False))
        icaos = rng.integers(1, 6, 40)
        rec2 = rng.random(40) < 0.4
        kept_t, n_t = trunner._gate_recover2_batch(idx, icaos, rec2, seen_t)
        kept_j, n_j = jrunner._gate_recover2_batch(idx, icaos, rec2, seen_j)
        np.testing.assert_array_equal(kept_t, kept_j)
        assert n_t == n_j and seen_t == seen_j


def test_locked_and_built_sinks():
    import threading

    lock = threading.Lock()
    table: dict = {}
    sink, tracker = tbatch.build_batched_sink(table, lock, extended=True, evict_after_s=5.0, ref_position=REF_POS)
    assert isinstance(tracker, tbatch.ExtendedBatchTracker) and tracker.aircrafts is table
    assert hasattr(sink, "on_extended_block") and hasattr(sink, "on_fields") and sink.tracker is tracker
    with pytest.warns(UserWarning):
        sink2, tracker2 = tbatch.build_batched_sink({}, lock, ref_position=REF_POS)
    assert not hasattr(sink2, "on_extended_block") and type(tracker2) is tbatch.BatchTracker
    a = tair.Aircraft(1)
    a.last_even_packet = TPacket.from_bytes(
        synth.make_df17(1, synth.make_position_me(11, 1000, 5, 6, False)), 1.0).msg
    tbatch.mirror_stash(a)
    assert a.last_even_packet == (5, 6)
    assert math.isclose(tcpr.calc_num_zones(0.0), 59)
