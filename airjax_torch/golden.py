"""Golden scalar decoder (airjax/golden.py, which imports nothing of jax
but is part of the JAX package, so the port keeps its own copy): a direct,
loop-based reimplementation of the reference's scan semantics
(src/adsb.rs:92-122, src/adsb/demod.rs, src/adsb/crc.rs), the independent
oracle of the parity decode (pipeline.decode_capture_parity, fused and
per chunk) on arbitrary (noisy) inputs.

Per-offset scalar logic over numpy magnitudes, structurally unlike the
kernels, so that a fault in one is unlikely to be repeated in the other.
"""

from __future__ import annotations

import numpy as np

from airjax_torch.protocol.crc import crc24, try_crc_recovery2_scalar, try_crc_recovery_scalar

_PRE_HIGHS = (0, 2, 7, 9)
_PRE_LOWS = (1, 3, 4, 5, 6, 8, 10, 11, 12, 13, 14, 15)
_DF_HIGHS = (0, 3, 5, 7, 8)
_DF_LOWS = (1, 2, 4, 6, 9)


def magnitude(iq: np.ndarray) -> np.ndarray:
    """u32-truncated f64 magnitude (src/utils.rs:46-52)."""
    re = iq[:, 0].astype(np.float64)
    im = iq[:, 1].astype(np.float64)
    return np.sqrt(re * re + im * im).astype(np.uint32)


def check_for_adsb_packet(buf: np.ndarray) -> bool:
    """Preamble + DF17 gate on a 32-sample window (demod.rs:17-57)."""
    for h in _PRE_HIGHS:
        for low in _PRE_LOWS:
            if buf[h] < buf[low]:
                return False
    for h in _DF_HIGHS:
        for low in _DF_LOWS:
            if buf[h + 16] < buf[low + 16]:
                return False
    return True


def extract_packet(buf: np.ndarray) -> bytes | None:
    """224 magnitudes -> 14 bytes if CRC passes (demod.rs:65-131,180-201).

    The active relative slicer never rejects; CRC (with single-bit
    recovery) is the only filter.
    """
    bits = buf[0::2] > buf[1::2]  # falling edge = 1
    packet = np.packbits(bits).tobytes()
    calced = crc24(packet[:11])
    packet_crc = (packet[11] << 16) | (packet[12] << 8) | packet[13]
    if calced == packet_crc:
        return packet
    return try_crc_recovery_scalar(packet)


def decode_chunk(iq_chunk: np.ndarray) -> list[tuple[int, bytes]]:
    """Scan one chunk exactly like process_sdr_data_thread (adsb.rs:92-122):
    stride-1 over offsets [0, len-240), duplicates kept."""
    mags = magnitude(iq_chunk)
    hits = []
    for i in range(len(mags) - 240):
        if check_for_adsb_packet(mags[i : i + 32]):
            packet = extract_packet(mags[i + 16 : i + 240])
            if packet is not None:
                hits.append((i, packet))
    return hits


def decode_capture_playback(iq: np.ndarray, chunk: int = 20000) -> list[tuple[int, int, bytes]]:
    """Full reference playback semantics: chunking per src/adsb.rs:75-89."""
    out = []
    i = 0
    c = 0
    while i < len(iq) - chunk:
        for off, packet in decode_chunk(iq[i : i + chunk]):
            out.append((c, off, packet))
        i += chunk
        c += 1
    return out


# ---------------------------------------------------------------------------
# Extended-mode scalar oracle (all downlink formats; the decode's counterpart
# is pipeline.decode_mags_block_extended)
# ---------------------------------------------------------------------------


def _check_preamble_only(buf: np.ndarray) -> bool:
    for h in _PRE_HIGHS:
        for low in _PRE_LOWS:
            if buf[h] < buf[low]:
                return False
    return True


def decode_chunk_extended(
    iq_chunk: np.ndarray, recover2: bool = False
) -> list[tuple[int, str, bytes, int]]:
    """Scalar classification of every preamble hit.

    Returns (offset, kind, frame_bytes, icao_ap) tuples where kind is one
    of 'long' (CRC-validated 112-bit, recovery applied), 'df11'
    (PI==CRC), 'short_ap' (DF4/5 candidate), 'long_ap' (DF16/20/21/24+
    candidate); icao_ap is the parity-recovered address (0 for 'long').

    recover2=True additionally classifies long frames repaired by a
    unique DOUBLE bit flip as kind 'long2' (pre-gate: the host assembly
    accepts them only for cache-validated ICAOs) — the scalar oracle for
    pipeline.decode_mags_block_extended(recover2=True).
    """
    mags = magnitude(iq_chunk)
    hits: list[tuple[int, str, bytes, int]] = []
    for i in range(len(mags) - 240):
        if not _check_preamble_only(mags[i : i + 32]):
            continue
        buf = mags[i + 16 : i + 240]
        bits = buf[0::2] > buf[1::2]
        packet = np.packbits(bits).tobytes()
        df = packet[0] >> 3
        if df >= 16:
            calced = crc24(packet[:11])
            pcrc = (packet[11] << 16) | (packet[12] << 8) | packet[13]
            if df in (16, 20, 21) or df >= 24:  # DF24+: Comm-D ELM, AP
                if calced ^ pcrc:  # address 0 is not a real aircraft
                    hits.append((i, "long_ap", packet, calced ^ pcrc))
                continue
            if calced == pcrc:
                hits.append((i, "long", packet, 0))
            else:
                fixed = try_crc_recovery_scalar(packet)
                if fixed is not None:
                    hits.append((i, "long", fixed, 0))
                elif recover2:
                    fixed2 = try_crc_recovery2_scalar(packet)
                    if fixed2 is not None:
                        hits.append((i, "long2", fixed2, 0))
        else:
            short = packet[:7]
            calced = crc24(short[:4])
            pi = (short[4] << 16) | (short[5] << 8) | short[6]
            if df == 11 and calced == pi:
                hits.append((i, "df11", short, 0))
            elif df == 11 and (calced ^ pi) < 80:  # interrogated all-call
                hits.append((i, "df11_ic", short, calced ^ pi))
            elif df in (0, 4, 5) and calced ^ pi:  # drop address 0
                hits.append((i, "short_ap", short, calced ^ pi))
    return hits
