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

Blocks are reduced to merged per-message COLUMNS in ascending offset
order; in extended mode they unify the pass-1 validated frames with the
cache-gated pass-2 candidates, where the simple kinds (DF11 all-calls,
DF4/DF5 surveillance, DF0 ACAS) are inline class codes instead of packet
objects. Fallback-free blocks (the common case) apply through `_vapply`,
a vectorized last-write-wins reduction whose host cost scales with
aircraft rather than messages; blocks holding complex kinds (DF16 MV-RA,
DF20/21 Comm-B, non-batched MEs) take the ordered zip walk (`_walk`)
with the per-packet path interleaved at each fallback's offset position.

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

# Subformat (3-bit CF/AF field) -> "ME is ADS-B-shaped" lookup tables:
# ~3x faster than np.isin on the small per-block subsets.
_DF18_CF_LUT = np.zeros(8, bool)
_DF18_CF_LUT[list(DF18_ADSB_CF)] = True
_DF19_AF_LUT = np.zeros(8, bool)
_DF19_AF_LUT[list(DF19_ADSB_AF)] = True

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
        # so those columns stay None (their masks never select them).
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
        State equivalence with the ordered walk / per-packet path is
        fuzzed in tests/test_torch_track.py.

        `C` holds numpy columns: cls, icao, alt, odd, clat, clon always;
        altv/sqk/vs and the 7 velocity columns only when an extended
        merge produced them (None ⇒ their classes cannot occur)."""
        from airjax_torch.extended import (
            CLS_ACAS,
            CLS_ALLCALL,
            CLS_SURV_ALT,
            CLS_SURV_SQK,
        )

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
        is_vel = cls == MSG_AIRCRAFT_VELOCITY
        extended = C.get("vst") is not None

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

        # --- last_contact: every class except AircraftID / Unknown ---
        lc = is_pos | is_vel
        if extended:
            lc |= cls >= CLS_ALLCALL
        for ic in set(icao[lc].tolist()):
            aircrafts[ic].last_contact = now

        # --- altitude: positions always; DF4 / DF0 when AC13 decoded ---
        aw = is_pos
        if extended:
            aw = aw | (
                ((cls == CLS_SURV_ALT) | (cls == CLS_ACAS))
                & C["altv"]
            )
        alt = C["alt"]
        for ic, v in dict(zip(icao[aw].tolist(), alt[aw].tolist())).items():
            aircrafts[ic].altitude = v

        # --- on_ground: positions clear it; DF0 ACAS sets VS ---
        og = is_pos
        if extended:
            acas = cls == CLS_ACAS
            og = og | acas
            og_val = acas & (C["vs"] != 0)
        else:
            og_val = np.zeros(len(cls), bool)
        for ic, v in dict(zip(icao[og].tolist(), og_val[og].tolist())).items():
            aircrafts[ic].on_ground = v

        # --- callsign (ID frames; decode only each aircraft's last) ---
        iw = np.nonzero(cls == MSG_AIRCRAFT_ID)[0]
        if len(iw):
            for ic, i in dict(zip(icao[iw].tolist(), iw.tolist())).items():
                aircrafts[ic].callsign = bytes(codes[i]).decode("ascii")

        if extended:
            # --- squawk (DF5) ---
            qw = cls == CLS_SURV_SQK
            if np.any(qw):
                sqk = C["sqk"]
                for ic, v in dict(
                    zip(icao[qw].tolist(), sqk[qw].tolist())
                ).items():
                    aircrafts[ic].squawk = v

        if extended and np.any(is_vel):
            # --- TC19 velocity: same integer->float math as the walk,
            # vectorized (numpy hypot/arctan2 vs math.* agree to ~1 ulp;
            # the equivalence fuzz compares at 1e-9 abs) ---
            vst = C["vst"]
            vw = (
                is_vel
                & ((vst == 1) | (vst == 2))
                & (C["vva"] != 0)
                & (C["vvb"] != 0)
            )
            if np.any(vw):
                scale = np.where(vst[vw] == 2, 4, 1)
                vx = (
                    (C["vva"][vw] - 1)
                    * scale
                    * np.where(C["vsa"][vw] != 0, -1, 1)
                )
                vy = (
                    (C["vvb"][vw] - 1)
                    * scale
                    * np.where(C["vsb"][vw] != 0, -1, 1)
                )
                gs = np.hypot(vx, vy)
                trk = np.degrees(np.arctan2(vx, vy)) % 360.0
                for ic, gt in dict(
                    zip(icao[vw].tolist(), zip(gs.tolist(), trk.tolist()))
                ).items():
                    a = aircrafts[ic]
                    a.ground_speed_kt = gt[0]
                    a.track_deg = gt[1]
            vrv = C["vrv"]
            rw = is_vel & (vrv != 0)
            if np.any(rw):
                vr = (vrv[rw] - 1) * 64 * np.where(
                    C["vrs"][rw] != 0, -1, 1
                )
                for ic, v in dict(
                    zip(icao[rw].tolist(), vr.tolist())
                ).items():
                    aircrafts[ic].vertical_rate_fpm = v

    def _walk(
        self,
        zcols: tuple,
        codes,
        altv,
        sqk,
        vsl,
        fb_payload,
        now: float,
        pair_jobs: list,
        touched: Optional[set],
        pending_icaos: Optional[set] = None,
    ) -> None:
        """Apply one block's messages in stream order from parallel
        columns. `zcols` is the 13-tuple of hot per-message lists
        (cls, icao, alt, odd, clat, clon, 7 velocity ints); `codes` is the
        (n, 8) uint8 callsign array; `altv`/`sqk`/`vsl` the surveillance
        alt-valid / squawk / vertical-status lists and `fb_payload` a
        {position: packet} dict — all rare, indexed only when their class
        code comes up (None where a path can't produce that class).

        Position pair decodes are APPENDED to pair_jobs, not resolved —
        the caller batches them through one vectorized decode_pairs call
        (_resolve_pairs): its fixed cost per call outweighs 1-2 pairs.
        A fallback packet that can itself write geo_position forces the
        pending pairs of its ICAO to resolve first (strict offset order
        for position fixes)."""
        from airjax_torch.extended import (
            CLS_ACAS,
            CLS_ALLCALL,
            CLS_FALLBACK_LONG,
            CLS_SURV_ALT,
            CLS_SURV_SQK,
        )

        aircrafts = self.aircrafts
        for i, (cls, icao, alt, odd, clat, clon, vst, vsa, vva, vsb, vvb, vrs, vrv) in enumerate(
            zip(*zcols)
        ):
            if cls >= CLS_FALLBACK_LONG:
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
                    a.ground_speed_kt = math.hypot(vx, vy)
                    a.track_deg = math.degrees(math.atan2(vx, vy)) % 360.0
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

        arr = np.asarray([j[:4] for j in pair_jobs], dtype=np.int64)
        newest = np.asarray([j[4] for j in pair_jobs], dtype=bool)
        lat, lon, valid = decode_pairs(
            arr[:, 0], arr[:, 1], arr[:, 2], arr[:, 3], newest
        )
        aircrafts = self.aircrafts
        for j, la, lo, ok in zip(pair_jobs, lat, lon, valid):
            if ok:
                aircrafts[j[5]].geo_position = GeographicPosition(
                    float(la), float(lo)
                )


class ExtendedBatchTracker(BatchTracker):
    """Extended-mode batched sink: a whole extended decode block's frames
    in one `on_extended_block` call.

    The inline walk covers the dominant ADS-B classes — AircraftID
    (TC1-4), airborne position (TC9-18) and velocity (TC19) from DF17 /
    DF18 CF 0,1,2,5,6 / DF19 AF 0 — AND the simple short-frame kinds
    (DF11 all-calls incl. cache-gated interrogated ones, DF4/DF5
    surveillance, DF0 ACAS), via device-extracted field arrays merged in
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
        in pass 1 and the runner skips only the emission."""
        from airjax_torch.extended import (
            CLS_ALLCALL,
            CLS_FALLBACK_LONG,
            CLS_FALLBACK_PKT,
            split_ap_candidates,
        )
        from airjax_torch.protocol.packet import AdsbPacket

        good_long = np.asarray(out["good_long"])
        good_df11 = np.asarray(out["good_df11"])
        # 2-flip-repaired frames (recover2 mode) never SEED the cache;
        # they are gated on it below, mirroring assemble_extended's
        # pass 1.5 exactly.
        rec2 = (
            np.asarray(out["recovered2"])
            if "recovered2" in out
            else np.zeros_like(good_long)
        )
        k_pass1 = np.nonzero((good_long & ~rec2) | good_df11)[0]
        fields = out["fields"]
        frames = np.asarray(out["frames"])
        frames_raw = np.asarray(out["frames_raw"])
        offsets = np.asarray(out["offsets"])

        # --- pass 1 column subsets (one fancy-index per field) ---
        from airjax_torch.extended import icao_from_raw

        gl1 = good_long[k_pass1]
        icao1 = np.where(
            gl1,
            np.asarray(fields["icao"])[k_pass1],
            icao_from_raw(frames_raw, k_pass1),
        )

        # Seed the acceptance cache with every pass-1 ICAO first (same
        # visibility as assemble_extended: pass 2 gating sees the whole
        # block's validated addresses).
        cache.add_many(icao1.tolist(), now)

        # Pass 1.5 (recover2): cache-gated repairs join the applied
        # pass-1 rows in offset order; rejected repairs vanish. The
        # repair class is rare, so the per-row contains() loop is cheap.
        k_rec2 = np.nonzero(good_long & rec2)[0]
        if len(k_rec2):
            ic_r2 = np.asarray(fields["icao"])[k_rec2]
            acc = np.fromiter(
                (cache.contains(int(i), now) for i in ic_r2),
                bool,
                len(ic_r2),
            )
            if np.any(acc):
                k_pass1 = np.sort(np.concatenate([k_pass1, k_rec2[acc]]))
                gl1 = good_long[k_pass1]
                icao1 = np.where(
                    gl1,
                    np.asarray(fields["icao"])[k_pass1],
                    icao_from_raw(frames_raw, k_pass1),
                )

        simple, complex_pkts = split_ap_candidates(
            out, now, cache, min_offset=min_offset
        )

        # Applied pass-1 subset (min_offset skips application only).
        if min_offset is not None:
            m = offsets[k_pass1] >= min_offset
            k1a, gl1a, icao1a = k_pass1[m], gl1[m], icao1[m]
        else:
            k1a, gl1a, icao1a = k_pass1, gl1, icao1
        df1 = np.asarray(fields["df"])[k1a]
        sub1 = np.asarray(fields["subformat"])[k1a]
        cls1 = np.asarray(fields["msg_class_ext"])[k1a]
        adsb_me = (
            (df1 == 17)
            | ((df1 == 18) & _DF18_CF_LUT[sub1])
            | ((df1 == 19) & _DF19_AF_LUT[sub1])
        )
        fast = (
            gl1a
            & adsb_me
            & (cls1 >= MSG_AIRCRAFT_ID)
            & (cls1 <= MSG_AIRCRAFT_VELOCITY)
        )
        cls_a = np.where(
            fast, cls1, np.where(gl1a, CLS_FALLBACK_LONG, CLS_ALLCALL)
        )

        n_a, n_s, n_c = len(k1a), len(simple["cls"]), len(complex_pkts)
        n = n_a + n_s + n_c
        applied = n
        touched: Optional[set] = set() if self.on_applied is not None else None

        if n:
            za = np.zeros(n_a, np.int64)
            zs = np.zeros(n_s, np.int64)
            zc = np.zeros(n_c, np.int64)

            off_all = np.concatenate(
                (
                    offsets[k1a].astype(np.int64),
                    simple["off"],
                    np.asarray([off for off, _ in complex_pkts], np.int64),
                )
            )
            order = np.argsort(off_all, kind="stable")
            identity = bool(np.all(order[1:] >= order[:-1])) if n > 1 else True

            def merged(a, s, c):
                m = np.concatenate((a, s, c))
                return m if identity else m[order]

            cls_m = merged(
                cls_a.astype(np.int64),
                simple["cls"],
                np.full(n_c, CLS_FALLBACK_PKT, np.int64),
            )
            C = {
                "cls": cls_m,
                "icao": merged(icao1a.astype(np.int64), simple["icao"], zc),
                "alt": merged(
                    np.asarray(fields["altitude_ft"])[k1a].astype(np.int64),
                    simple["alt"],
                    zc,
                ),
                "altv": merged(
                    np.ones(n_a, bool), simple["alt_valid"], np.zeros(n_c, bool)
                ),
                "sqk": merged(za, simple["squawk"], zc),
                "vs": merged(za, simple["vs"], zc),
            }
            for short, key in (
                ("odd", "cpr_odd"), ("clat", "cpr_lat"), ("clon", "cpr_lon")
            ):
                C[short] = merged(
                    np.asarray(fields[key])[k1a].astype(np.int64), zs, zc
                )
            any_vel = bool(np.any(cls_a == MSG_AIRCRAFT_VELOCITY))
            for short, key in _VEL_KEYS:
                C[short] = (
                    merged(
                        np.asarray(fields[key])[k1a].astype(np.int64), zs, zc
                    )
                    if any_vel
                    else za if n == n_a else np.zeros(n, np.int64)
                )
            codes = merged(
                np.asarray(fields["callsign_codes"])[k1a],
                np.zeros((n_s, 8), np.uint8),
                np.zeros((n_c, 8), np.uint8),
            )

            # Fallback payloads, prebuilt at their merged positions.
            fb_payload: dict[int, object] = {}
            if n_c or not bool(np.all(fast | ~gl1a)):
                k_m = merged(k1a.astype(np.int64), zs, zc)
                for i in np.nonzero(cls_m == CLS_FALLBACK_LONG)[0].tolist():
                    fb_payload[i] = AdsbPacket.from_bytes(
                        frames[k_m[i]].tobytes(), now, extensions=True
                    )
                ci = np.nonzero(cls_m == CLS_FALLBACK_PKT)[0].tolist()
                for i, (_off, pkt) in zip(ci, complex_pkts):
                    fb_payload[i] = pkt

            if not fb_payload and not getattr(self, "_force_walk", False):
                self._vapply(C, codes, now, touched)
            else:
                # Ordered walk: exact per-packet interleaving around the
                # complex fallback kinds.
                zcols = tuple(
                    C[k].tolist()
                    for k in (
                        "cls", "icao", "alt", "odd", "clat", "clon",
                        "vst", "vsa", "vva", "vsb", "vvb", "vrs", "vrv",
                    )
                )
                pair_jobs: list[tuple] = []
                self._walk(
                    zcols, codes, C["altv"].tolist(), C["sqk"].tolist(),
                    C["vs"].tolist(), fb_payload, now, pair_jobs, touched,
                    set(),
                )
                self._resolve_pairs(pair_jobs)

        if self.evict_after_s is not None:
            from airjax_torch.track.aircraft import evict_stale

            evict_stale(self.aircrafts, self.evict_after_s, now=now)
        self.n_messages += applied
        if touched is not None and applied:
            self.on_applied(touched)
        return applied


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
