"""Batched online tracker: a whole decode block's frames in one update
(airjax/track/batch.py, carried over unchanged).

The per-packet host path (AdsbPacket.from_bytes + handle_aircraft_update
per frame, the shape of the reference's thread-3 consumer,
src/adsb.rs:149-167) parses every frame's bytes in Python. This sink
takes the block's protocol fields instead, extracted on the card by the
block-decode kernel's F flag (csrc/fields.cuh, through
airjax_torch.pipeline.decode_iq_block_with_fields), so the per-frame host
work shrinks to a few dict and attribute operations, and all CPR pair
decodes of a block run through the vectorized
airjax_torch.track.cpr_batch at once.

An extended block takes one row pass (ExtendedBatchTracker): its rows
selected once in ascending offset order (`select_rows`: the pass-1
validated frames and the cache-gated pass-2 candidates, one nonzero),
the ICAO cache seeded and asked once an address (`_gate`), then each row
classed and applied in order (`_walk`): the simple kinds (DF11
all-calls, DF4/DF5 surveillance, DF0 ACAS) and the dominant ADS-B
classes as inline class codes, the complex kinds (DF16 MV-RA, DF20/21
Comm-B, non-batched MEs) through the per-packet path at their row, and
the block's CPR pairs in one vectorized decode. A block's cost is a few
dozen numpy calls and one Python step a row, a whole capture's
(multihost's) included. DF17 blocks (`BatchTracker.on_fields`) take
`_vapply`, a vectorized last-write-wins reduction whose host cost scales
with aircraft rather than messages.

Semantics are EXACTLY the per-packet tracker's (parity scope: the DF17
pipeline's AircraftID / AircraftPosition / Unknown classes,
src/adsb/aircraft.rs:48-111); tests/test_torch_track.py fuzzes the port
against airjax's trackers:

  * every validated frame upserts its ICAO (even Unknown class);
  * ID messages set the callsign (and nothing else — not last_contact);
  * position messages set altitude + last_contact, stash by CPR parity,
    and pair with an opposite-parity stash <= 10 s old (the newest frame
    picks the formulas; NL-gate failures leave the position unchanged).
"""

from __future__ import annotations

import math
import typing
from typing import Optional

import numpy as np

from airjax_torch.protocol.fields import (
    MSG_AIRCRAFT_ID,
    MSG_AIRCRAFT_POSITION,
    MSG_AIRCRAFT_VELOCITY,
)
from airjax_torch.track.aircraft import Aircraft, CPR_PAIR_MAX_AGE_S
from airjax_torch.track.cpr import GeographicPosition

from airjax_torch.protocol.packet import DF18_ADSB_CF, DF19_ADSB_AF

# (df, subformat) -> "the ME is ADS-B-shaped": DF17, DF18 with an ADS-B CF
# and DF19 with an ADS-B AF (the 5-bit DF and the 3-bit CF/AF field).
_ADSB_ME = np.zeros((32, 8), bool)
_ADSB_ME[17] = True
_ADSB_ME[18, list(DF18_ADSB_CF)] = True
_ADSB_ME[19, list(DF19_ADSB_AF)] = True

# Names of the 13 hot per-message columns the ordered walk zips over (the
# rare columns — callsign codes, surveillance alt-valid/squawk/VS,
# fallback payloads — are indexed by position instead).
_VEL_KEYS = (
    ("vst", "vel_subtype"),
    ("vsa", "vel_sign_a"),
    ("vva", "vel_val_a"),
    ("vsb", "vel_sign_b"),
    ("vvb", "vel_val_b"),
    ("vrs", "vel_vr_sign"),
    ("vrv", "vel_vr_val"),
)

# A row's kind (ExtendedBatchTracker._gate): 0 a pass-1 long frame, 1 a
# DF11 all-call, 2 a short AP reply (DF0/4/5), 3 a long AP reply
# (DF16/20/21/24). The row pass walks the fields of _ROW_WALK_KEYS (the 13
# values `_walk` unpacks, class, address and altitude set by kind) and,
# for short AP replies, those of _ROW_SHORT_KEYS.
_ROW_WALK_KEYS = (
    "msg_class_ext", "icao", "altitude_ft", "cpr_odd", "cpr_lat", "cpr_lon",
) + tuple(key for _, key in _VEL_KEYS)
_ROW_SHORT_KEYS = ("altitude_ft", "altitude_valid", "squawk", "vs")


def _kind_classes() -> np.ndarray:
    """(kind, df of the raw frame) -> the walk's class of a row that is
    not an inline ADS-B row: a DF11 all-call; DF4, DF5 or (DF0) ACAS for a
    short AP reply; the per-packet path otherwise."""
    from airjax_torch.extended import CLS_ACAS, CLS_ALLCALL, CLS_FALLBACK_LONG, CLS_SURV_ALT, CLS_SURV_SQK

    table = np.full((4, 32), CLS_FALLBACK_LONG, np.int64)
    table[1] = CLS_ALLCALL
    table[2] = CLS_ACAS
    table[2, 4], table[2, 5] = CLS_SURV_ALT, CLS_SURV_SQK
    return table


_KIND_CLASSES = _kind_classes()
# The AA's three raw bytes (frame bytes 1-3) -> the address.
_AA_WEIGHTS = np.array([1 << 16, 1 << 8, 1], np.int64)


def select_rows(out: dict) -> np.ndarray:
    """The row pass's selection of an extended block: one union mask of
    pass 1 (`good_long`, recover2's repairs among them, and `good_df11`)
    and the AP and interrogated DF11 candidates, one nonzero -> the slots
    in ascending offset order (a stable sort; the block decode and
    multihost's gather already hand them so)."""
    sel = np.nonzero(
        np.asarray(out["good_long"])
        | np.asarray(out["good_df11"])
        | np.asarray(out["cand_df11_ic"])
        | np.asarray(out["cand_short_ap"])
        | np.asarray(out["cand_long_ap"])
    )[0]
    return sel[np.argsort(np.asarray(out["offsets"])[sel], kind="stable")]


class CprStash(typing.NamedTuple):
    """Batched-path CPR stash: a tuple (so batch-path code can unpack it)
    that also exposes the AircraftPositionMsg attribute names, so a later
    per-packet update on the same aircraft (extended-mode fallback classes
    route through Aircraft.handle_packet) can pair against it."""

    cpr_latitude: int
    cpr_longitude: int


class BatchTracker:
    """Tracker sink consuming (fields, indices, timestamp) per block.

    Exposes the same `aircrafts` dict of Aircraft objects as the
    per-packet path, so UIs / checkpointing work unchanged. Also usable
    as a plain per-packet sink via __call__ (falls back to the classic
    path for odd callers), but its point is `on_fields`.
    """

    def __init__(self, evict_after_s: Optional[float] = None):
        self.aircrafts: dict[int, Aircraft] = {}
        self.evict_after_s = evict_after_s
        self.n_messages = 0
        # Optional per-block hook: called with the set of ICAOs whose
        # aircraft were touched by the block just applied (UI sinks
        # broadcast one summary per touched aircraft per block instead
        # of one per message — see airjax_torch.ui.web.WebDisplay.batched_sink).
        self.on_applied: Optional[callable] = None

    # --- per-packet fallback (so the sink is drop-in for run_stream) ---
    def __call__(self, packet) -> None:
        from airjax_torch.extended import handle_extended_update

        handle_extended_update(
            packet,
            self.aircrafts,
            ref_position=getattr(self, "ref_position", None),
        )
        self.n_messages += 1
        if self.evict_after_s is not None:
            from airjax_torch.track.aircraft import evict_stale

            evict_stale(
                self.aircrafts, self.evict_after_s, now=packet.time_processed
            )
        if self.on_applied is not None:
            self.on_applied({packet.icao})

    # --- the batched path ---
    def on_fields(self, fields: dict, idx: np.ndarray, now: float) -> int:
        """Apply `idx`-selected frames of a block's field arrays.

        `fields` is the fetched dict of
        airjax_torch.protocol.fields.extract_fields; `idx` selects the
        CRC-validated slots in ascending offset (stream) order.
        Returns the number of messages applied. Parity (DF17) classing;
        the extended-mode block path is ExtendedBatchTracker's
        on_extended_block, which merges pass-2 candidates into the same
        walk."""
        n = len(idx)
        if n == 0:
            return 0

        def take(key):
            return np.asarray(fields[key])[idx]

        # Parity classing never produces velocity / surveillance codes,
        # so _vapply reads no column of theirs.
        C = {
            "cls": take("msg_class"),
            "icao": take("icao"),
            "alt": take("altitude_ft"),
            "odd": take("cpr_odd"),
            "clat": take("cpr_lat"),
            "clon": take("cpr_lon"),
        }
        codes = np.asarray(fields["callsign_codes"])[idx]
        touched = set() if self.on_applied is not None else None
        self._vapply(C, codes, now, touched)
        if self.evict_after_s is not None:
            from airjax_torch.track.aircraft import evict_stale

            evict_stale(self.aircrafts, self.evict_after_s, now=now)
        self.n_messages += n
        if touched is not None:
            self.on_applied(touched)
        return n

    def _vapply(self, C, codes, now: float, touched: Optional[set]) -> None:
        """Vectorized block apply for fallback-free blocks (the common
        case). Because every message in a block shares one timestamp,
        per-aircraft final state is a LAST-WRITE-WINS reduction per field;
        `dict(zip(icaos, values))` computes that reduction at C speed, so
        host work scales with *aircraft*, not messages. CPR pairing — the
        one genuinely order-dependent part — is reproduced exactly with a
        segmented previous-opposite-parity scan (see inline comments).
        State equivalence with the per-packet path is fuzzed in
        tests/test_torch_track.py.

        `C` holds the numpy columns cls, icao, alt, odd, clat, clon of a
        parity-classed block (IDs, positions and Unknown)."""
        cls = C["cls"]
        icao = C["icao"]
        aircrafts = self.aircrafts
        if touched is not None:
            touched.update(icao.tolist())

        # Upsert every aircraft in first-occurrence (stream) order — the
        # per-packet path's dict insertion order.
        first = np.unique(icao, return_index=True)[1]
        for ic in icao[np.sort(first)].tolist():
            if ic not in aircrafts:
                aircrafts[ic] = Aircraft(ic)

        is_pos = cls == MSG_AIRCRAFT_POSITION

        # --- CPR pairing (BEFORE stash updates: partner-less positions
        # must see the pre-block stashes, exactly like the walk) ---
        pi = np.nonzero(is_pos)[0]
        mp = len(pi)
        if mp:
            ic_p = icao[pi]
            op = np.argsort(ic_p, kind="stable")  # group by aircraft,
            # stream order within each group (updates to different
            # aircraft commute; within one they must stay ordered)
            ic_s = ic_p[op]
            od_s = C["odd"][pi][op] != 0
            la_s = C["clat"][pi][op]
            lo_s = C["clon"][pi][op]
            idx = np.arange(mp)
            seg_new = np.empty(mp, bool)
            seg_new[0] = True
            seg_new[1:] = ic_s[1:] != ic_s[:-1]
            first_of = idx[seg_new][np.cumsum(seg_new) - 1]  # segment start

            def prev_in_seg(parity_mask):
                # Index of the latest strictly-earlier same-segment
                # position with the given parity; -1 if none. A global
                # running max never leaks across segments because indices
                # are monotone: anything from an earlier segment is
                # < this segment's start.
                v = np.where(parity_mask, idx, -1)
                acc = np.maximum.accumulate(v)
                prev = np.empty(mp, np.int64)
                prev[0] = -1
                prev[1:] = acc[:-1]
                return np.where(prev >= first_of, prev, -1)

            partner = np.where(
                od_s, prev_in_seg(~od_s), prev_in_seg(od_s)
            )
            safe = np.maximum(partner, 0)
            e_lat = np.where(od_s, la_s[safe], la_s)
            e_lon = np.where(od_s, lo_s[safe], lo_s)
            o_lat = np.where(od_s, la_s, la_s[safe])
            o_lon = np.where(od_s, lo_s, lo_s[safe])
            has = partner >= 0
            need_stash = np.nonzero(~has)[0].tolist()
            ic_sl = ic_s.tolist() if need_stash else None
            for j in need_stash:
                # No in-block opposite-parity predecessor: pair against
                # the pre-block stash when one exists and is fresh.
                a = aircrafts[ic_sl[j]]
                if od_s[j]:
                    other, other_t = a.last_even_packet, a.last_even_processed
                else:
                    other, other_t = a.last_odd_packet, a.last_odd_processed
                if other is None or abs(now - other_t) > CPR_PAIR_MAX_AGE_S:
                    continue
                if not isinstance(other, tuple):
                    other = (other.cpr_latitude, other.cpr_longitude)
                if od_s[j]:
                    e_lat[j], e_lon[j] = other
                else:
                    o_lat[j], o_lon[j] = other
                has[j] = True
            if np.any(has):
                from airjax_torch.track.cpr_batch import decode_pairs

                h = np.nonzero(has)[0]
                lat, lon, valid = decode_pairs(
                    e_lat[h], e_lon[h], o_lat[h], o_lon[h], od_s[h]
                )
                # Applied in per-aircraft stream order: a later valid fix
                # overwrites, a later invalid one leaves the earlier.
                for ic, la, lo, ok in zip(
                    ic_s[h].tolist(), lat, lon, valid
                ):
                    if ok:
                        aircrafts[ic].geo_position = GeographicPosition(
                            float(la), float(lo)
                        )
            # Stash the newest frame per parity per aircraft.
            ev = ~od_s
            for ic, st in dict(
                zip(ic_s[ev].tolist(), zip(la_s[ev].tolist(), lo_s[ev].tolist()))
            ).items():
                a = aircrafts[ic]
                a.last_even_packet = CprStash(*st)
                a.last_even_processed = now
            for ic, st in dict(
                zip(ic_s[od_s].tolist(), zip(la_s[od_s].tolist(), lo_s[od_s].tolist()))
            ).items():
                a = aircrafts[ic]
                a.last_odd_packet = CprStash(*st)
                a.last_odd_processed = now

        # --- last_contact, altitude, on_ground: positions (IDs and
        # Unknown leave them) ---
        pos_icao = icao[is_pos].tolist()
        for ic in set(pos_icao):
            a = aircrafts[ic]
            a.last_contact = now
            a.on_ground = False
        for ic, v in dict(zip(pos_icao, C["alt"][is_pos].tolist())).items():
            aircrafts[ic].altitude = v

        # --- callsign (ID frames; decode only each aircraft's last) ---
        iw = np.nonzero(cls == MSG_AIRCRAFT_ID)[0]
        if len(iw):
            for ic, i in dict(zip(icao[iw].tolist(), iw.tolist())).items():
                aircrafts[ic].callsign = bytes(codes[i]).decode("ascii")

    def _walk(
        self,
        rows,
        codes,
        altv,
        sqk,
        vsl,
        fb_payload,
        now: float,
        pair_jobs: list,
        touched: Optional[set],
        pending_icaos: Optional[set] = None,
    ) -> int:
        """Apply one block's messages in stream order; returns how many.
        `rows` yields each message's 13 hot values (cls, icao, alt, odd,
        clat, clon, 7 velocity ints); `codes` maps a message's position to
        its 8 callsign codes, `altv`/`sqk`/`vsl` to its surveillance
        alt-valid / squawk / vertical status and `fb_payload` to its
        packet — all rare, indexed only when their class code comes up.

        Position pair decodes are APPENDED to pair_jobs, not resolved —
        the caller batches them through one vectorized decode_pairs call
        (_resolve_pairs): its fixed cost per call outweighs 1-2 pairs.
        A fallback packet that can itself write geo_position forces the
        pending pairs of its ICAO to resolve first (strict offset order
        for position fixes).

        Ground speed and track take airjax's float expression for the
        block: math.* at the row once the block has met a fallback row
        (airjax's walk), one numpy expression over the block's ground
        velocities when it meets none (airjax's `_vapply`). Until the first
        fallback they wait in `ground`; nothing between writes them."""
        from airjax_torch.extended import (
            CLS_ACAS,
            CLS_ALLCALL,
            CLS_FALLBACK_LONG,
            CLS_SURV_ALT,
            CLS_SURV_SQK,
        )

        aircrafts = self.aircrafts
        ground: Optional[list] = []  # None once a fallback row was met
        i = -1
        for i, (cls, icao, alt, odd, clat, clon, vst, vsa, vva, vsb, vvb, vrs, vrv) in enumerate(rows):
            if cls >= CLS_FALLBACK_LONG:
                if ground:
                    for a, vx, vy in ground:
                        a.ground_speed_kt = math.hypot(vx, vy)
                        a.track_deg = math.degrees(math.atan2(vx, vy)) % 360.0
                ground = None
                self._apply_fallback(
                    fb_payload[i], now, pair_jobs, pending_icaos, touched
                )
                continue
            if touched is not None:
                touched.add(icao)
            a = aircrafts.get(icao)
            if a is None:
                a = aircrafts[icao] = Aircraft(icao)
            if cls == MSG_AIRCRAFT_POSITION:
                a.altitude = alt
                a.last_contact = now
                a.on_ground = False
                if odd:
                    a.last_odd_packet = CprStash(clat, clon)
                    a.last_odd_processed = now
                    other, other_t = a.last_even_packet, a.last_even_processed
                    newest_odd = True
                else:
                    a.last_even_packet = CprStash(clat, clon)
                    a.last_even_processed = now
                    other, other_t = a.last_odd_packet, a.last_odd_processed
                    newest_odd = False
                if other is not None and not isinstance(other, tuple):
                    # A per-packet update (__call__ / fallback) stashed a
                    # message object; normalize so mixed use keeps pairing.
                    other = (other.cpr_latitude, other.cpr_longitude)
                if other is not None and abs(now - other_t) <= CPR_PAIR_MAX_AGE_S:
                    e_lat, e_lon = other if newest_odd else (clat, clon)
                    o_lat, o_lon = (clat, clon) if newest_odd else other
                    pair_jobs.append((e_lat, e_lon, o_lat, o_lon, newest_odd, icao))
                    if pending_icaos is not None:
                        pending_icaos.add(icao)
            elif cls == MSG_AIRCRAFT_VELOCITY:
                # Exact AircraftVelocityMsg.from_me ground-velocity +
                # vertical-rate math (packet.py:208-253) on the raw
                # device-extracted integers.
                a.last_contact = now
                if vst in (1, 2) and vva != 0 and vvb != 0:
                    scale = 4 if vst == 2 else 1
                    vx = (vva - 1) * scale * (-1 if vsa else 1)
                    vy = (vvb - 1) * scale * (-1 if vsb else 1)
                    if ground is None:
                        a.ground_speed_kt = math.hypot(vx, vy)
                        a.track_deg = math.degrees(math.atan2(vx, vy)) % 360.0
                    else:
                        ground.append((a, vx, vy))
                if vrv != 0:
                    a.vertical_rate_fpm = (vrv - 1) * 64 * (-1 if vrs else 1)
            elif cls == MSG_AIRCRAFT_ID:
                a.callsign = bytes(codes[i]).decode("ascii")
            elif cls == CLS_ALLCALL:
                a.last_contact = now
            elif cls == CLS_SURV_ALT:
                a.last_contact = now
                if altv[i]:
                    a.altitude = alt
            elif cls == CLS_SURV_SQK:
                a.last_contact = now
                a.squawk = sqk[i]
            elif cls == CLS_ACAS:
                a.last_contact = now
                if altv[i]:
                    a.altitude = alt
                a.on_ground = bool(vsl[i])
            # MSG_UNKNOWN: upsert only (src/adsb/aircraft.rs:107-109).
        if ground:
            vx = np.array([g[1] for g in ground], np.int64)
            vy = np.array([g[2] for g in ground], np.int64)
            gs = np.hypot(vx, vy)
            trk = np.degrees(np.arctan2(vx, vy)) % 360.0
            for (a, _, _), g, t in zip(ground, gs.tolist(), trk.tolist()):
                a.ground_speed_kt = g
                a.track_deg = t
        return i + 1

    def _apply_fallback(
        self,
        pkt,
        now: float,
        pair_jobs: list,
        pending_icaos: Optional[set],
        touched: Optional[set],
    ) -> None:
        """Exact per-packet path for the complex kinds, interleaved at
        stream position. Only a position-carrying AdsbPacket can write
        geo_position; every other fallback kind (AllCall/Surveillance/
        Acas replies, status/velocity/unknown MEs) commutes with the
        deferred pair decodes."""
        from airjax_torch.extended import handle_extended_update
        from airjax_torch.protocol.packet import (
            AdsbPacket,
            AircraftPositionMsg,
            SurfacePositionMsg,
        )

        if (
            pending_icaos
            and pkt.icao in pending_icaos
            and isinstance(pkt, AdsbPacket)
            and isinstance(pkt.msg, (AircraftPositionMsg, SurfacePositionMsg))
        ):
            mine = [j for j in pair_jobs if j[5] == pkt.icao]
            pair_jobs[:] = [j for j in pair_jobs if j[5] != pkt.icao]
            pending_icaos.discard(pkt.icao)
            self._resolve_pairs(mine)
        handle_extended_update(
            pkt, self.aircrafts, ref_position=getattr(self, "ref_position", None)
        )
        if touched is not None:
            touched.add(pkt.icao)

    def _resolve_pairs(self, pair_jobs: list) -> None:
        """One vectorized CPR decode for a batch of
        (e_lat, e_lon, o_lat, o_lon, newest_odd, icao) jobs, applied in
        order (a later failed pairing leaves the earlier position, like
        the per-packet path)."""
        if not pair_jobs:
            return
        from airjax_torch.track.cpr_batch import decode_pairs

        e_lat, e_lon, o_lat, o_lon, newest, icaos = zip(*pair_jobs)
        lat, lon, valid = decode_pairs(e_lat, e_lon, o_lat, o_lon, newest)
        aircrafts = self.aircrafts
        for icao, la, lo, ok in zip(icaos, lat.tolist(), lon.tolist(), valid.tolist()):
            if ok:
                aircrafts[icao].geo_position = GeographicPosition(la, lo)


class ExtendedBatchTracker(BatchTracker):
    """Extended-mode batched sink: a whole extended decode block's frames
    in one `on_extended_block` call.

    The inline walk covers the dominant ADS-B classes — AircraftID
    (TC1-4), airborne position (TC9-18) and velocity (TC19) from DF17 /
    DF18 CF 0,1,2,5,6 / DF19 AF 0 — AND the simple short-frame kinds
    (DF11 all-calls incl. cache-gated interrogated ones, DF4/DF5
    surveillance, DF0 ACAS), via device-extracted field arrays in
    ascending offset order; only complex kinds (other MEs needing the
    typed decode — TC0/5-8/20-22/28/29/31, non-ADS-B ME — plus DF16
    MV-RA and DF20/21 Comm-B) fall back to the exact per-packet path at
    their stream position. Tracker state is IDENTICAL to feeding
    assemble_extended's sorted packet list through
    handle_extended_update one at a time (fuzzed in
    tests/test_torch_track.py).
    """

    def __init__(
        self,
        evict_after_s: Optional[float] = None,
        ref_position: Optional[tuple] = None,
    ):
        super().__init__(evict_after_s)
        self.ref_position = ref_position
        # Blocks applied, and the rows of them that took the per-packet
        # path (`adsb --batched --extended` prints both in its stats line).
        self.blocks = 0
        self.fallback_rows = 0

    def on_extended_block(
        self, out: dict, now: float, cache, min_offset: int | None = None
    ) -> int:
        """Apply one extended device dict (must carry `fields`,
        i.e. produced by decode_iq_block_extended_with_fields). `cache`
        is the stream's IcaoCache. Returns messages applied.

        `min_offset` (overlap streams: the zero-padded head of the very
        first block) suppresses APPLICATION of any slot below it while
        still seeding the acceptance cache with its ICAO — exactly the
        per-packet path's split, where assemble_extended registers ICAOs
        in pass 1 and the runner skips only the emission.

        One row pass, whatever the call's size: its rows selected once
        (`select_rows`), the cache seeded and asked (`_gate`), each row
        classed and applied in offset order (`_walk_block`), the CPR pairs
        decoded in one call (`_resolve_pairs`)."""
        touched: Optional[set] = set() if self.on_applied is not None else None
        kept, addr, kind = self._gate(out, select_rows(out), now, cache, min_offset)
        pair_jobs: list[tuple] = []
        applied, fallbacks = self._walk_block(out, kept, addr, kind, now, pair_jobs, touched)
        self._resolve_pairs(pair_jobs)
        self.blocks += 1
        self.fallback_rows += fallbacks
        if self.evict_after_s is not None:
            from airjax_torch.track.aircraft import evict_stale

            evict_stale(self.aircrafts, self.evict_after_s, now=now)
        self.n_messages += applied
        if touched is not None and applied:
            self.on_applied(touched)
        return applied

    @staticmethod
    def _gate(
        out: dict, sel: np.ndarray, now: float, cache, min_offset: int | None
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Seed `cache` with every pass-1 address of the selected slots
        (slots below `min_offset` too), then ask it once an address for the
        rows it gates: recover2's repairs (below `min_offset` too) and the
        AP and interrogated DF11 candidates at or above it, as
        assemble_extended asks -> the slots to apply, in order, with the
        address and the kind (the comment above _ROW_WALK_KEYS) of each."""
        long_ok = np.asarray(out["good_long"])[sel]
        df11_ok = np.asarray(out["good_df11"])[sel]
        df11 = df11_ok | np.asarray(out["cand_df11_ic"])[sel]
        short_ap = np.asarray(out["cand_short_ap"])[sel]
        rec2 = out.get("recovered2")
        rec2 = long_ok & np.asarray(rec2)[sel] if rec2 is not None else np.zeros_like(long_ok)
        kind = np.where(long_ok, 0, np.where(df11, 1, np.where(short_ap, 2, 3)))
        addr = np.choose(
            kind,
            (
                np.asarray(out["fields"]["icao"])[sel],
                np.asarray(out["frames_raw"])[sel, 1:4].astype(np.int64) @ _AA_WEIGHTS,
                np.asarray(out["icao_ap_short"])[sel],
                np.asarray(out["icao_ap_long"])[sel],
            ),
        )
        seed = (long_ok & ~rec2) | df11_ok
        cache.add_many(addr[seed].tolist(), now)
        if min_offset is None:
            keep, ask = seed, rec2 | ~seed
        else:
            due = np.asarray(out["offsets"])[sel] >= min_offset
            keep, ask = seed & due, rec2 | (~seed & due)
        asked = addr[ask].tolist()
        if asked:
            contains = cache.contains
            accepted = {icao: contains(icao, now) for icao in dict.fromkeys(asked)}
            keep[ask] = [accepted[icao] for icao in asked]
            if min_offset is not None:
                keep &= due
        return sel[keep], addr[keep], kind[keep]

    def _walk_block(
        self,
        out: dict,
        kept: np.ndarray,
        addr: np.ndarray,
        kind: np.ndarray,
        now: float,
        pair_jobs: list,
        touched: Optional[set],
    ) -> tuple[int, int]:
        """Gather the applied slots' columns once, class every row in them
        and apply the rows in order (`_walk`): pass 1's ADS-B rows, DF11
        all-calls and the short AP replies (DF0/4/5) inline; pass 1's other
        long frames through AdsbPacket.from_bytes and the long AP replies
        (DF16/20/21/24) as packets (extended.ap_reply), built before the
        walk. A candidate's short fields come from `short_fields`, or from
        the scalar host decode where the block has none. -> (messages
        applied, fallback rows)."""
        from airjax_torch.extended import CLS_FALLBACK_LONG, _short_fields_host, ap_reply
        from airjax_torch.protocol.packet import AdsbPacket

        fields = out["fields"]
        frames_raw = np.asarray(out["frames_raw"])
        sf = out.get("short_fields")
        cols = [np.asarray(fields[key])[kept] for key in _ROW_WALK_KEYS]
        cls = cols[0]
        df_long = np.asarray(fields["df"])[kept]
        sub = np.asarray(fields["subformat"])[kept]
        df = np.asarray(out["df"])[kept]
        surv = kind == 2
        if sf is None:
            alt, altv, sqk, vs = (np.zeros(len(kept), np.int64) for _ in range(4))
            for i in np.nonzero(surv)[0].tolist():
                host = _short_fields_host(frames_raw[kept[i]].tobytes()[:7])
                altv[i] = host["altitude_ft"] is not None
                alt[i], sqk[i], vs[i] = host["altitude_ft"] or 0, host["squawk"], host["vs"]
        else:
            alt, altv, sqk, vs = (np.asarray(sf[key])[kept] for key in _ROW_SHORT_KEYS)
        # Pass 1's rows the walk applies inline: ADS-B MEs of the three
        # classes; every other row takes its kind's class.
        inline = (kind == 0) & _ADSB_ME[df_long, sub] & (cls >= MSG_AIRCRAFT_ID) & (cls <= MSG_AIRCRAFT_VELOCITY)
        cls = np.where(inline, cls, _KIND_CLASSES[kind, df])
        cols[:3] = cls, addr, np.where(surv, np.where(altv, alt, 0), cols[2])

        fb_payload: dict = {}
        fallback = np.nonzero(cls == CLS_FALLBACK_LONG)[0].tolist()
        if fallback:
            frames = np.asarray(out["frames"])
            for i in fallback:
                k = int(kept[i])
                if kind[i] == 0:
                    fb_payload[i] = AdsbPacket.from_bytes(frames[k].tobytes(), now, extensions=True)
                    continue
                raw = frames_raw[k].tobytes()
                if sf is None:
                    short = _short_fields_host(raw[:7])
                else:
                    short = {key: int(sf[key][k]) for key in ("fs", "squawk", "vs", "sl", "ri")}
                    short["altitude_ft"] = int(alt[i]) if altv[i] else None
                fb_payload[i] = ap_reply(int(df[i]), raw, int(addr[i]), short, now)

        applied = self._walk(
            zip(*[col.tolist() for col in cols]),
            np.asarray(fields["callsign_codes"])[kept],
            altv.tolist(),
            sqk.tolist(),
            vs.tolist(),
            fb_payload,
            now,
            pair_jobs,
            touched,
            set(),
        )
        return applied, len(fb_payload)


def locked_sink(inner, lock, extended: bool = False):
    """Wrap a (Extended)BatchTracker so every tracker mutation happens
    under `lock` — the UI sinks (web server's HTTP snapshot, the TUI's
    render loop) read the shared aircraft table from another thread.
    The wrapper exposes exactly the interfaces run_stream auto-detects:
    __call__ (per-packet fallback), on_fields, and (extended only)
    on_extended_block. `inner.on_applied` callbacks run WITH the lock
    held — they must not re-acquire it."""

    class LockedSink:
        aircrafts = inner.aircrafts
        tracker = inner

        def __call__(self, packet):
            with lock:
                inner(packet)

        def on_fields(self, *a, **k):
            with lock:
                return inner.on_fields(*a, **k)

        if extended:

            def on_extended_block(self, *a, **k):
                with lock:
                    return inner.on_extended_block(*a, **k)

    return LockedSink()


def build_batched_sink(
    aircrafts: dict,
    lock,
    extended: bool = False,
    evict_after_s: Optional[float] = None,
    ref_position=None,
):
    """Shared construction recipe for the UI batched sinks (TUI, web):
    pick the tracker class by `extended`, share the caller's aircraft
    table, and wrap in locked_sink. Returns (sink, tracker); callers
    set `tracker.on_applied` afterwards (it is read at call time, so
    assignment after wrapping is safe).

    Note: `ref_position` (surface-position decode) only takes effect
    with extended=True — the parity BatchTracker never sees surface
    CPR messages (reference classing has no TC5-8 class). Passing a
    receiver position without extended mode warns and ignores it (the
    per-packet parity path accepts-and-ignores it the same way)."""
    if extended:
        tracker = ExtendedBatchTracker(
            evict_after_s=evict_after_s, ref_position=ref_position
        )
    else:
        if ref_position is not None:
            import warnings

            warnings.warn(
                "ref_position has no effect without extended=True (the "
                "parity batched sink never decodes surface positions)",
                stacklevel=2,
            )
        tracker = BatchTracker(evict_after_s=evict_after_s)
    tracker.aircrafts = aircrafts
    return locked_sink(tracker, lock, extended=extended), tracker


def mirror_stash(aircraft: Aircraft) -> None:
    """Per-packet Aircraft stashes AircraftPositionMsg objects; BatchTracker
    stashes (cpr_lat, cpr_lon) tuples. Both pair identically — this helper
    exists only so equivalence tests can normalize before comparing."""
    for attr in ("last_even_packet", "last_odd_packet"):
        v = getattr(aircraft, attr)
        if v is not None and not isinstance(v, tuple):
            setattr(aircraft, attr, (v.cpr_latitude, v.cpr_longitude))
