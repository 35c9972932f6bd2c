"""Host assembly for the extended (all downlink formats) decode mode
(airjax/extended.py:34-288).

Turns the candidate dict of `airjax_torch.pipeline.decode_iq_block_extended`
(host arrays) into typed packets:

  pass 1 (in offset order): CRC-validated frames — DF17+ long frames (the
  reference path, emitted as AdsbPacket) and DF11 all-call replies —
  registering their ICAOs in the acceptance cache;
  pass 2: AP-addressed DF0/4/5/16/20/21/24 candidates and interrogated
  DF11 all-calls, accepted only when their ICAO is in the cache
  (airjax_torch.track.icao_cache).

The producers of airjax's other inputs are not ported yet, so neither are
their branches here: the 2-bit repairs of `recover2` (airjax's pass 1.5)
and the device-extracted `short_fields`; the fields of every candidate
come from the scalar host decode `_short_fields_host`. The batched sink's
`split_ap_candidates`, ELM reassembly (`assemble_elm`, `interpret_elm`)
and `handle_extended_update` wait for the batched-tracker slice.
"""

from __future__ import annotations

from typing import Union

import numpy as np

from airjax_torch.protocol.acas import decode_mv_ra
from airjax_torch.protocol.commb import infer_bds
from airjax_torch.protocol.packet import (
    AcasReply,
    AdsbPacket,
    AllCallReply,
    CommDReply,
    SurveillanceReply,
    squawk_from_id13,
)
from airjax_torch.track.icao_cache import IcaoCache

ExtendedPacket = Union[
    AcasReply, AdsbPacket, AllCallReply, CommDReply, SurveillanceReply
]


def _gillham_altitude_host(ac13: np.ndarray) -> int | None:
    """Scalar Q=0 Gillham (100 ft gray) altitude: gray decode by
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


def icao_from_raw(frames_raw, idx) -> np.ndarray:
    """Cleartext 3-byte big-endian address at bytes 1..3 of raw frames —
    the AA field of DF11 all-calls."""
    fr = np.asarray(frames_raw)
    return (
        (fr[idx, 1].astype(np.int64) << 16)
        | (fr[idx, 2].astype(np.int64) << 8)
        | fr[idx, 3]
    )


def _short_fields_host(frame7: bytes) -> dict:
    """Scalar short/AP frame field decode."""
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
    good_long = np.asarray(out["good_long"])
    good_df11 = np.asarray(out["good_df11"])

    results: list[tuple[int, ExtendedPacket]] = []

    # Pass 1: CRC-validated frames register ICAOs.
    for k in np.nonzero(good_long | good_df11)[0]:
        off = int(offsets[k])
        if good_long[k]:
            pkt = AdsbPacket.from_bytes(frames[k].tobytes(), now, extensions=True)
            cache.add(pkt.icao, now)
            results.append((off, pkt))
        else:
            icao = int(icao_from_raw(frames_raw, k))
            cache.add(icao, now)
            results.append(
                (off, AllCallReply(icao=icao, capability=int(frames_raw[k, 0]) & 0b111, time_processed=now))
            )

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
    ascending offset order."""
    offsets = np.asarray(out["offsets"])
    frames_raw = np.asarray(out["frames_raw"])
    df = np.asarray(out["df"])
    cand_df11_ic = np.asarray(out["cand_df11_ic"])
    cand_short = np.asarray(out["cand_short_ap"])
    cand_long = np.asarray(out["cand_long_ap"])
    icao_short = np.asarray(out["icao_ap_short"])
    icao_long = np.asarray(out["icao_ap_long"])

    results: list[tuple[int, ExtendedPacket]] = []
    for k in np.nonzero(cand_short | cand_long | cand_df11_ic)[0].tolist():
        off = int(offsets[k])
        raw = frames_raw[k].tobytes()
        if cand_df11_ic[k]:
            aa = int(icao_from_raw(frames_raw, k))
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
        fields = _short_fields_host(raw[:7])
        d = int(df[k])
        if d in (0, 16):  # ACAS air-air (altitude in the same AC13 slot)
            results.append(
                (
                    off,
                    AcasReply(
                        df=d,
                        icao=icao,
                        vertical_status=fields["vs"],
                        sensitivity_level=fields["sl"],
                        reply_information=fields["ri"],
                        altitude_ft=fields["altitude_ft"],
                        time_processed=now,
                        ra=decode_mv_ra(raw[4:11]) if d == 16 else None,
                    ),
                )
            )
            continue
        if d >= 24:  # Comm-D ELM segment (AP-addressed like DF20/21)
            results.append(
                (
                    off,
                    CommDReply(
                        icao=icao,
                        ke=(raw[0] >> 4) & 1,
                        nd=raw[0] & 0xF,
                        md=raw[1:11],
                        time_processed=now,
                        # The 5-bit field runs 24-31 (its low bits are
                        # KE/ND); report the canonical format number.
                        df=24,
                    ),
                )
            )
            continue
        results.append(
            (
                off,
                SurveillanceReply(
                    df=d,
                    icao=icao,
                    flight_status=fields["fs"],
                    altitude_ft=fields["altitude_ft"] if d in (4, 20) else None,
                    squawk=fields["squawk"] if d in (5, 21) else None,
                    time_processed=now,
                    bds=(infer_bds(raw[4:11]) or None) if d in (20, 21) else None,
                ),
            )
        )

    results.sort(key=lambda t: t[0])
    return results
