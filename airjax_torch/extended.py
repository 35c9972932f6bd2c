"""Host assembly for the extended (all downlink formats) decode mode
(airjax/extended.py, carried over unchanged).

Turns the candidate dict of `airjax_torch.pipeline.decode_iq_block_extended`
(host arrays) into typed packets:

  pass 1 (in offset order): CRC-validated frames — DF17+ long frames (the
  reference path, emitted as AdsbPacket) and DF11 all-call replies —
  registering their ICAOs in the acceptance cache;
  pass 1.5 (recover2): long frames validated only by the 2-bit repair,
  emitted only when their ICAO is already in the cache, never seeding it;
  pass 2: AP-addressed DF0/4/5/16/20/21/24 candidates accepted only when
  their parity-recovered ICAO is in the cache (airjax_torch.track.icao_cache).

The rest serves the batched tracker (airjax_torch.track.batch): the
inline class codes, `ap_reply`, the Comm-D ELM reassembly
(`assemble_elm`, `interpret_elm`) and `handle_extended_update`; and
`split_ap_candidates`, airjax's batched pass 2, carried over.
"""

from __future__ import annotations

from typing import Union

import numpy as np

from airjax_torch.protocol.packet import (
    AcasReply,
    AdsbPacket,
    AllCallReply,
    CommDReply,
    SurveillanceReply,
)
from airjax_torch.track.icao_cache import IcaoCache

ExtendedPacket = Union[
    AcasReply, AdsbPacket, AllCallReply, CommDReply, SurveillanceReply
]


def _gillham_altitude_host(ac13: np.ndarray) -> int | None:
    """Scalar Q=0 Gillham (100 ft gray) altitude — independent of the
    vectorized decoder in airjax_torch.protocol.shortframe: gray decode by
    sequential XOR accumulation."""
    c1, a1, c2, a2, c4, a4 = (int(b) for b in ac13[:6])
    b1, b2, d2, b4, d4 = (int(ac13[i]) for i in (7, 9, 10, 11, 12))

    def gray_seq(bits_msb_first: list[int]) -> int:
        value = 0
        acc = 0
        for bit in bits_msb_first:
            acc ^= bit
            value = (value << 1) | acc
        return value

    ones = gray_seq([c1, c2, c4])
    if (ones & 5) == 5:
        ones ^= 2
    if ones == 0 or ones > 5:
        return None
    fives = gray_seq([d2, d4, a1, a2, a4, b1, b2, b4])
    if fives % 2:
        ones = 6 - ones
    return fives * 500 + ones * 100 - 1300


def icao_from_raw(frames_raw, idx) -> "np.ndarray":
    """Cleartext 3-byte big-endian address at bytes 1..3 of raw frames —
    the AA field of DF11 all-calls. One site for the bit assembly the
    batched sink and both assembly passes share."""
    fr = np.asarray(frames_raw)
    return (
        (fr[idx, 1].astype(np.int64) << 16)
        | (fr[idx, 2].astype(np.int64) << 8)
        | fr[idx, 3]
    )


def _short_fields_host(frame7: bytes) -> dict:
    """Scalar short/AP frame field decode (numpy-free host path)."""
    bits = np.unpackbits(np.frombuffer(frame7, np.uint8))
    ac13 = bits[19:32]
    n11 = np.concatenate([ac13[0:6], ac13[7:8], ac13[9:13]])
    n_val = int(n11.dot(1 << np.arange(10, -1, -1)))
    m_bit, q_bit = int(ac13[6]), int(ac13[8])
    if m_bit != 0:
        altitude = None  # metric encoding: unsupported, like dump1090
    elif q_bit == 1:
        altitude = n_val * 25 - 1000
    else:
        altitude = _gillham_altitude_host(ac13)
    from airjax_torch.protocol.packet import squawk_from_id13

    squawk = squawk_from_id13(int(ac13.dot(1 << np.arange(12, -1, -1))))
    return {
        "fs": int((frame7[0] & 0b111)),
        "altitude_ft": altitude,
        "squawk": squawk,
        # DF0/16 ACAS header fields (same 32 data bits, different layout)
        "vs": int(bits[5]),
        "sl": int((bits[8] << 2) | (bits[9] << 1) | bits[10]),
        "ri": int((bits[13] << 3) | (bits[14] << 2) | (bits[15] << 1) | bits[16]),
    }


def assemble_extended(
    out: dict, now: float, cache: IcaoCache
) -> list[tuple[int, ExtendedPacket]]:
    """(candidate dict, timestamp) -> [(offset, packet)] in offset order."""
    offsets = np.asarray(out["offsets"])
    frames = np.asarray(out["frames"])
    frames_raw = np.asarray(out["frames_raw"])
    df = np.asarray(out["df"])
    good_long = np.asarray(out["good_long"])
    good_df11 = np.asarray(out["good_df11"])
    cand_df11_ic = np.asarray(out["cand_df11_ic"])
    cand_short = np.asarray(out["cand_short_ap"])
    cand_long = np.asarray(out["cand_long_ap"])
    icao_short = np.asarray(out["icao_ap_short"])
    icao_long = np.asarray(out["icao_ap_long"])

    results: list[tuple[int, ExtendedPacket]] = []

    # Frames validated only via the opt-in 2-bit repair (`recovered2`,
    # decode_mags_block_extended(recover2=True)) are NOT independent
    # evidence — a >=3-bit burst can alias to a repair of a different
    # codeword — so they neither seed the cache nor emit unless their
    # ICAO is already accepted (same gate as the AP candidates).
    rec2 = (
        np.asarray(out["recovered2"])
        if "recovered2" in out
        else np.zeros_like(good_long)
    )

    # Pass 1: CRC-validated frames register ICAOs.
    for k in np.nonzero((good_long & ~rec2) | good_df11)[0]:
        off = int(offsets[k])
        if good_long[k]:
            pkt = AdsbPacket.from_bytes(frames[k].tobytes(), now, extensions=True)
            cache.add(pkt.icao, now)
            results.append((off, pkt))
        else:
            raw = frames_raw[k].tobytes()
            icao = (raw[1] << 16) | (raw[2] << 8) | raw[3]
            cache.add(icao, now)
            results.append(
                (off, AllCallReply(icao=icao, capability=raw[0] & 0b111, time_processed=now))
            )

    # Pass 1.5: 2-flip-repaired long frames, cache-gated (the cache
    # already holds this block's pass-1 ICAOs — same visibility as the
    # AP candidates below).
    for k in np.nonzero(good_long & rec2)[0]:
        pkt = AdsbPacket.from_bytes(frames[k].tobytes(), now, extensions=True)
        if cache.contains(pkt.icao, now):
            results.append((int(offsets[k]), pkt))

    results.extend(assemble_ap_candidates(out, now, cache))
    results.sort(key=lambda t: t[0])
    return results


def assemble_ap_candidates(
    out: dict, now: float, cache: IcaoCache
) -> list[tuple[int, ExtendedPacket]]:
    """Pass 2 of extended assembly: candidates gated on the ICAO cache —
    AP-addressed frames (the CRC residual IS the address) and interrogated
    DF11 all-calls (the AA is cleartext but PI ^ CRC is an interrogator
    code, so the checksum no longer independently validates). The cache
    must already hold every ICAO pass 1 validated. Returns packets in
    ascending offset order.

    When `out` carries `short_fields` (the
    airjax_torch.protocol.shortframe.extract_short_fields arrays of
    decode_iq_block_extended_with_fields, from the block-decode kernel), the
    per-candidate field decode rides those; otherwise the independent
    scalar host decode (_short_fields_host) runs per frame."""
    offsets = np.asarray(out["offsets"])
    frames_raw = np.asarray(out["frames_raw"])
    df = np.asarray(out["df"])
    cand_df11_ic = np.asarray(out["cand_df11_ic"])
    cand_short = np.asarray(out["cand_short_ap"])
    cand_long = np.asarray(out["cand_long_ap"])
    icao_short = np.asarray(out["icao_ap_short"])
    icao_long = np.asarray(out["icao_ap_long"])

    ks = np.nonzero(cand_short | cand_long | cand_df11_ic)[0]
    if not len(ks):
        return []
    sf = out.get("short_fields")
    if sf is not None:
        sf_l = {
            key: np.asarray(sf[key])[ks].tolist()
            for key in ("fs", "altitude_ft", "altitude_valid", "squawk", "vs", "sl", "ri")
        }

    results: list[tuple[int, ExtendedPacket]] = []
    for j, k in enumerate(ks.tolist()):
        off = int(offsets[k])
        raw = frames_raw[k].tobytes()
        if cand_df11_ic[k]:
            aa = (raw[1] << 16) | (raw[2] << 8) | raw[3]
            if cache.contains(aa, now):
                results.append(
                    (
                        off,
                        AllCallReply(
                            icao=aa,
                            capability=raw[0] & 0b111,
                            time_processed=now,
                            interrogator=int(icao_short[k]),
                        ),
                    )
                )
            continue
        icao = int(icao_short[k] if cand_short[k] else icao_long[k])
        if not cache.contains(icao, now):
            continue
        if sf is not None:
            fields = {
                "fs": sf_l["fs"][j],
                "altitude_ft": (
                    sf_l["altitude_ft"][j] if sf_l["altitude_valid"][j] else None
                ),
                "squawk": sf_l["squawk"][j],
                "vs": sf_l["vs"][j],
                "sl": sf_l["sl"][j],
                "ri": sf_l["ri"][j],
            }
        else:
            fields = _short_fields_host(raw[:7])
        results.append((off, ap_reply(int(df[k]), raw, icao, fields, now)))

    results.sort(key=lambda t: t[0])
    return results


def ap_reply(d: int, raw: bytes, icao: int, fields: dict, now: float) -> ExtendedPacket:
    """The packet of one accepted AP-addressed candidate of downlink
    format `d`: its raw frame bytes, its gated address and its short-frame
    fields (fs, altitude_ft or None, squawk, vs, sl, ri). One site for
    assemble_ap_candidates and the batched sink's complex rows."""
    if d in (0, 16):  # ACAS air-air (altitude in the same AC13 slot)
        ra = None
        if d == 16:
            from airjax_torch.protocol.acas import decode_mv_ra

            ra = decode_mv_ra(raw[4:11])
        return AcasReply(
            df=d,
            icao=icao,
            vertical_status=fields["vs"],
            sensitivity_level=fields["sl"],
            reply_information=fields["ri"],
            altitude_ft=fields["altitude_ft"],
            time_processed=now,
            ra=ra,
        )
    if d >= 24:  # Comm-D ELM segment (AP-addressed like DF20/21)
        return CommDReply(
            icao=icao,
            ke=(raw[0] >> 4) & 1,
            nd=raw[0] & 0xF,
            md=raw[1:11],
            time_processed=now,
            # The 5-bit field runs 24-31 (its low bits are KE/ND); report
            # the canonical format number.
            df=24,
        )
    bds = None
    if d in (20, 21):
        from airjax_torch.protocol.commb import infer_bds

        bds = infer_bds(raw[4:11]) or None
    return SurveillanceReply(
        df=d,
        icao=icao,
        flight_status=fields["fs"],
        altitude_ft=fields["altitude_ft"] if d in (4, 20) else None,
        squawk=fields["squawk"] if d in (5, 21) else None,
        time_processed=now,
        bds=bds,
    )


# Inline class codes for the batched extended walk
# (airjax_torch.track.batch.ExtendedBatchTracker): tracker updates for these
# kinds need no per-packet host decode, so the batched sink applies them
# straight from field arrays. Values sit above the device msg_class /
# msg_class_ext codes (airjax_torch.protocol.fields, 0-3).
CLS_ALLCALL = 8  # DF11 (validated or cache-gated interrogated): upsert
CLS_SURV_ALT = 9  # DF4: altitude (when valid) + last_contact
CLS_SURV_SQK = 10  # DF5: squawk + last_contact
CLS_ACAS = 11  # DF0: altitude + on_ground(VS) + last_contact
CLS_FALLBACK_LONG = 12  # pass-1 long frame -> AdsbPacket.from_bytes
CLS_FALLBACK_PKT = 13  # pass-2 packet needing per-packet host decode


def split_ap_candidates(
    out: dict, now: float, cache: IcaoCache, min_offset: int | None = None
) -> tuple[dict, list[tuple[int, ExtendedPacket]]]:
    """Pass 2 for airjax's batched sink (the port's ExtendedBatchTracker
    gates its candidates in its row pass instead): same ICAO-cache gating as
    assemble_ap_candidates, but kinds whose tracker update is pure field
    writes (DF4/DF5 surveillance, DF0 ACAS, interrogated DF11) come back
    as parallel numpy arrays instead of packet objects; only DF16 (MV RA
    decode) and DF20/21 (Comm-B BDS inference) build packets through the
    per-packet path. Both halves are in ascending offset order.

    Returns (simple, complex) where simple is a dict of equal-length
    arrays {"off", "cls", "icao", "alt", "alt_valid", "squawk", "vs"}
    (cls = the CLS_* codes above) and complex is [(offset, packet)].
    Equivalence with airjax's is enforced by tests/test_torch_track.py."""
    offsets = np.asarray(out["offsets"])
    frames_raw = np.asarray(out["frames_raw"])
    df = np.asarray(out["df"])
    cand_df11_ic = np.asarray(out["cand_df11_ic"])
    cand_short = np.asarray(out["cand_short_ap"])
    cand_long = np.asarray(out["cand_long_ap"])
    icao_short = np.asarray(out["icao_ap_short"])
    icao_long = np.asarray(out["icao_ap_long"])

    def empty():
        out = {
            key: np.zeros(0, np.int64)
            for key in ("off", "cls", "icao", "alt", "squawk", "vs")
        }
        # bool, NOT int: the consumer combines this into boolean masks,
        # and an int dtype would silently flip them to integer
        # fancy-indexing.
        out["alt_valid"] = np.zeros(0, bool)
        return out

    ks = np.nonzero(cand_short | cand_long | cand_df11_ic)[0]
    if min_offset is not None and len(ks):
        ks = ks[offsets[ks] >= min_offset]
    if not len(ks):
        return empty(), []

    # Gate addresses: interrogated DF11s gate on the cleartext AA; AP
    # frames on the parity-recovered ICAO.
    aa = icao_from_raw(frames_raw, ks)
    gate_icao = np.where(
        cand_df11_ic[ks],
        aa,
        np.where(cand_short[ks], icao_short[ks], icao_long[ks]),
    ).astype(np.int64)
    # One cache lookup per UNIQUE address (a block's candidates repeat
    # few aircraft); contains() side effects (expiry deletion) hit the
    # same unique set as per-candidate lookups would.
    contains = cache.contains
    uniq, inv = np.unique(gate_icao, return_inverse=True)
    accept = np.fromiter(
        (contains(int(ic), now) for ic in uniq), bool, len(uniq)
    )[inv]
    ks, gate_icao = ks[accept], gate_icao[accept]
    if not len(ks):
        return empty(), []

    dfk = df[ks].astype(np.int64)
    is_df11 = cand_df11_ic[ks].astype(bool)
    simple_mask = is_df11 | np.isin(dfk, (0, 4, 5))
    km = ks[simple_mask]
    cls = np.select(
        [
            is_df11[simple_mask],
            dfk[simple_mask] == 4,
            dfk[simple_mask] == 5,
        ],
        [CLS_ALLCALL, CLS_SURV_ALT, CLS_SURV_SQK],
        default=CLS_ACAS,
    )
    sf = out.get("short_fields")
    if sf is not None:
        alt = np.asarray(sf["altitude_ft"])[km].astype(np.int64)
        alt_valid = np.asarray(sf["altitude_valid"])[km].astype(bool)
        squawk = np.asarray(sf["squawk"])[km].astype(np.int64)
        vs = np.asarray(sf["vs"])[km].astype(np.int64)
    else:  # oracle path: independent scalar host decode per candidate
        hosts = [_short_fields_host(frames_raw[k].tobytes()[:7]) for k in km]
        alt = np.asarray(
            [h["altitude_ft"] or 0 for h in hosts], np.int64
        )
        alt_valid = np.asarray(
            [h["altitude_ft"] is not None for h in hosts], bool
        )
        squawk = np.asarray([h["squawk"] for h in hosts], np.int64)
        vs = np.asarray([h["vs"] for h in hosts], np.int64)
    simple = {
        "off": offsets[km].astype(np.int64),
        "cls": cls.astype(np.int64),
        "icao": gate_icao[simple_mask],
        "alt": np.where(alt_valid, alt, 0),
        "alt_valid": alt_valid,
        "squawk": squawk,
        "vs": vs,
    }

    # Complex kinds (DF16 / DF20 / DF21) through the existing per-packet
    # assembly, gated subset only; its own cache.contains re-checks pass.
    complex_pkts: list[tuple[int, ExtendedPacket]] = []
    kc = ks[~simple_mask]
    if len(kc):
        sub = dict(out)
        keep = np.zeros(len(offsets), bool)
        keep[kc] = True
        for key in ("cand_short_ap", "cand_long_ap", "cand_df11_ic"):
            sub[key] = np.asarray(out[key]) & keep
        complex_pkts = assemble_ap_candidates(sub, now, cache)
    return simple, complex_pkts


def assemble_elm(
    segments: dict | None, expected_segments: int | None = None
) -> bytes | None:
    """Reassemble a Comm-D ELM from an aircraft's commd_segments stash
    ({str(nd): md_hex}): the in-order concatenation of segments
    0..ND_max; None while interior gaps remain.

    The downlink alone does not announce the segment COUNT (it is fixed
    by the interrogator's UF24 RC field, which a passive receiver never
    sees), so a missing TRAILING segment is undecidable from the stash:
    a gapless prefix 0..k is returned as-is. Pass `expected_segments`
    when the count is known out-of-band to also reject short prefixes."""
    if not segments:
        return None
    nds = sorted(int(k) for k in segments)
    if nds != list(range(nds[-1] + 1)):
        return None
    if expected_segments is not None and len(nds) != expected_segments:
        return None
    return b"".join(bytes.fromhex(segments[str(i)]) for i in nds)


def interpret_elm(payload: bytes, gicb_supported=None) -> dict:
    """Comm-D ELM content interpretation (VERDICT r4 item 4; capability
    beyond the reference's src/adsb/msgs.rs:32-34, which stores raw
    bytes). The downlink announces no payload type, so interpretation is
    heuristic: register-shaped payloads (a GICB extraction delivered via
    ELM instead of Comm-B) run through the same BDS inference machinery
    as DF20/21 MB fields (airjax_torch.protocol.commb.infer_bds) on the first
    7 bytes — including the per-aircraft capability pruning the Comm-B
    path applies (`gicb_supported`: the aircraft's BDS 1,7 report, so an
    ambiguity the capability already resolved decodes here too).

    Returns {"hex": full payload hex, "segments": segment count,
    "bds": sorted candidate register list (may be empty —
    non-register payload), "decoded": the decoded dict when the
    inference is unambiguous (sole candidate)}.
    """
    from airjax_torch.protocol.commb import infer_bds, prune_by_capability

    n_seg = (len(payload) + 9) // 10
    cands = infer_bds(payload[:7]) if len(payload) >= 7 else {}
    cands = prune_by_capability(cands, gicb_supported)
    out: dict = {
        "hex": payload.hex(),
        "segments": n_seg,
        "bds": sorted(cands),
    }
    if len(cands) == 1:
        ((_, dec),) = cands.items()
        out["decoded"] = dec if isinstance(dec, dict) else {"value": dec}
    return out


def handle_extended_update(
    packet: ExtendedPacket, aircrafts: dict, ref_position=None
) -> None:
    """Feed extension packets into the aircraft table (AdsbPacket goes
    through the standard reference-parity path). `ref_position`
    (receiver lat, lon) enables surface-position decode."""
    from airjax_torch.track.aircraft import Aircraft, handle_aircraft_update

    if isinstance(packet, AdsbPacket):
        handle_aircraft_update(packet, aircrafts, ref_position=ref_position)
        return
    aircraft = aircrafts.setdefault(packet.icao, Aircraft(packet.icao))
    aircraft.last_contact = packet.time_processed
    if isinstance(packet, CommDReply):
        # ELM segment stash (keys stringified: JSON checkpoints would
        # silently convert int keys anyway). A full ELM is the in-order
        # concatenation of segments 0..ND_max once all arrive.
        if aircraft.commd_segments is None:
            aircraft.commd_segments = {}
        aircraft.commd_segments[str(packet.nd)] = packet.md.hex()
        # Content interpretation on every gapless prefix (trailing
        # completeness is undecidable from the downlink alone — see
        # assemble_elm): latest prefix wins, like every other field.
        payload = assemble_elm(aircraft.commd_segments)
        if payload is not None:
            aircraft.commd_elm = interpret_elm(
                payload, gicb_supported=aircraft.gicb_supported
            )
        return
    if isinstance(packet, AcasReply):
        if packet.altitude_ft is not None:
            aircraft.altitude = packet.altitude_ft
        aircraft.on_ground = bool(packet.vertical_status)
        if packet.ra is not None:
            aircraft.acas_ra = packet.ra  # extension attribute
        return
    if isinstance(packet, SurveillanceReply):
        if packet.altitude_ft is not None:
            aircraft.altitude = packet.altitude_ft
        if packet.squawk is not None:
            aircraft.squawk = packet.squawk  # extension attribute
        if packet.bds:
            from airjax_torch.protocol.commb import prune_by_capability

            # Capability tracking (VERDICT r3 item 4): an unambiguous
            # BDS 1,7 report announces which GICB registers this
            # transponder services; remember it per aircraft.
            if set(packet.bds) == {"1,7"}:
                aircraft.gicb_supported = sorted(
                    packet.bds["1,7"]["supported"]
                )
            # ...and use the announced capability to shrink ambiguous
            # inferences: a candidate register the aircraft says it does
            # not service cannot be what the interrogator read back.
            bds = prune_by_capability(packet.bds, aircraft.gicb_supported)
            # Surface inference ambiguity (VERDICT r1 item 8): record every
            # register the MB validated as; >1 entry tells consumers the
            # reading is uncertain (carried as bdsCandidates in the
            # extended WS schema).
            aircraft.bds_candidates = sorted(bds)
            # Comm-B registers (extension): BDS 2,0 callsign; 5,0/6,0
            # velocity fields feed the same extension attributes as TC19.
            # infer_bds's contract: multi-register matches are UNCERTAIN.
            # 2,0 has a strong structural signature (0x20 + charset) and
            # is applied regardless; 5,0 vs 6,0 is the classic Comm-B
            # ambiguity — apply those only when exactly one validated, or
            # a misread heading would overwrite a correct TC19 velocity.
            cs = bds.get("2,0")
            if cs and aircraft.callsign is None:
                aircraft.callsign = cs
            b30 = bds.get("3,0")
            if isinstance(b30, dict):
                aircraft.acas_ra = b30  # Comm-B RA report (BDS 3,0)
            # Sole-candidate rule for the round-4 registers (consistent
            # with the 5,0/6,0 ambiguity discipline): apply only when the
            # MB validated as exactly this register.
            if len(bds) == 1:
                b44 = bds.get("4,4")
                if isinstance(b44, dict):
                    aircraft.met = b44  # meteorological routine report
                b40 = bds.get("4,0")
                if isinstance(b40, dict) and "mcp_alt_ft" in b40:
                    aircraft.selected_altitude_ft = b40["mcp_alt_ft"]
            # A structural match on 1,0/1,7/3,0 (explicit BDS-code or
            # reserved-zero signatures) makes a coincidental 5,0/6,0
            # velocity reading suspect — skip it then.
            structural = any(k in bds for k in ("1,0", "1,7", "3,0"))
            b50 = bds.get("5,0")
            b60 = bds.get("6,0")
            if isinstance(b50, dict) and b60 is None and not structural:
                if "ground_speed_kt" in b50:
                    aircraft.ground_speed_kt = float(b50["ground_speed_kt"])
                if "track_deg" in b50:
                    aircraft.track_deg = b50["track_deg"]
            if (
                isinstance(b60, dict)
                and b50 is None
                and not structural
                and "baro_vs_fpm" in b60
            ):
                aircraft.vertical_rate_fpm = b60["baro_vs_fpm"]
