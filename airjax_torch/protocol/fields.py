"""ADS-B protocol fields of a batch of frames as vectorized integer ops
(airjax/protocol/fields.py), and the constants the host packet model and
the synthetic frame makers share.

Replicates the reference's per-packet scalar decode (src/adsb/packet.rs:
25-49, src/adsb/msgs.rs:69-206) over a whole (N, 14)-byte batch,
including its quirks:

  * capability = byte0 & 5      (reference bug, kept for bit-exact parity;
                                 the spec says & 0x7)
  * altitude   = code * (25|100) - 1000 with Q-bit = msg[1] & 1
  * callsign from 6-bit chunks of ME bytes 1..7 against the reference's
    64-char table with '#' placeholders

Message classing follows src/adsb/packet.rs:32-38: TC 1-4 -> AircraftID,
TC 9-18 -> AircraftPosition, else Unknown.

`extract_fields` is the plain torch version; the batched decode paths run
it on the card as csrc/fields.cu (airjax_torch/kernels/fields.py).
"""

from __future__ import annotations

import numpy as np
import torch

# src/adsb/msgs.rs:172-177
CHAR_CONVERT = (
    "#ABCDEFGHIJKLMNOPQRSTUVWXYZ#####_###############0123456789######"
)
_CHAR_TABLE = np.frombuffer(CHAR_CONVERT.encode("ascii"), dtype=np.uint8).copy()

MSG_UNKNOWN = 0
MSG_AIRCRAFT_ID = 1
MSG_AIRCRAFT_POSITION = 2
# Extension class (extended mode): the reference leaves TC19 Unknown.
MSG_AIRCRAFT_VELOCITY = 3


def extract_fields(frames: torch.Tensor) -> dict[str, torch.Tensor]:
    """(..., 14) uint8 frames -> every protocol field, (...)-shaped int32
    tensors (airjax/protocol/fields.py:36-143), `alt_mode_25` bool and
    `callsign_codes` (..., 8) uint8 ASCII. Fields that do not apply to a
    frame's class are computed all the same; `msg_class` says which do."""
    b = frames.to(torch.int32)
    b0, b1, b2, b3, b4 = b[..., 0], b[..., 1], b[..., 2], b[..., 3], b[..., 4]
    # ME field bytes (src/adsb/packet.rs:33-35 uses packet[4..11] as msg[0..7])
    m1, m2 = b[..., 5], b[..., 6]
    m3, m4, m5, m6 = b[..., 7], b[..., 8], b[..., 9], b[..., 10]

    msg_type = b4 >> 3
    is_id = (msg_type >= 1) & (msg_type <= 4)
    is_pos = (msg_type >= 9) & (msg_type <= 18)
    msg_class = is_id.to(torch.int32) * MSG_AIRCRAFT_ID + is_pos.to(torch.int32) * MSG_AIRCRAFT_POSITION

    # --- AircraftPosition (src/adsb/msgs.rs:70-101) ---
    alt_mode_25 = (m1 & 1) == 1
    alt_code = (((m1 & 0xFE) >> 1) << 4) | ((m2 & 0xF0) >> 4)
    altitude = alt_code * (25 * alt_mode_25.to(torch.int32) + 100 * (~alt_mode_25).to(torch.int32)) - 1000

    # --- AircraftID callsign: ME bytes 1..7 = 48 bits = 8 six-bit chunks,
    # as two 24-bit halves ---
    hi24 = (m1 << 16) | (m2 << 8) | m3
    lo24 = (m4 << 16) | (m5 << 8) | m6
    chunks = torch.stack(
        [(h >> s) & 0x3F for h in (hi24, lo24) for s in (18, 12, 6, 0)], dim=-1
    ).to(torch.int64)
    callsign_codes = torch.as_tensor(_CHAR_TABLE, device=frames.device)[chunks]

    out = {
        "df": b0 >> 3,
        # CF (DF18) / AF (DF19): the full low 3 bits, not the &5 quirk.
        "subformat": b0 & 0b111,
        "capability": b0 & 5,  # parity quirk, see the module docstring
        "icao": (b1 << 16) | (b2 << 8) | b3,
        "msg_type": msg_type,
        "msg_class": msg_class,
        "altitude_ft": altitude,
        "alt_mode_25": alt_mode_25,
        "surveillance_status": (b4 & 0b110) >> 1,
        "nic_supplement": b4 & 1,
        "cpr_time": (m2 & 0b1000) >> 3,
        "cpr_odd": (m2 & 0b100) >> 2,  # 1 = odd frame
        "cpr_lat": ((m2 & 0b11) << 15) | (m3 << 7) | ((m4 & 0xFE) >> 1),
        "cpr_lon": ((m4 & 1) << 16) | (m5 << 8) | m6,
        "callsign_codes": callsign_codes,
        # TC19 airborne velocity raw fields (extension): sign + 10-bit pairs.
        "msg_class_ext": torch.where(msg_type == 19, MSG_AIRCRAFT_VELOCITY, msg_class).to(torch.int32),
        "vel_subtype": b4 & 0x7,
        "vel_sign_a": (m1 >> 2) & 1,
        "vel_val_a": ((m1 & 0x3) << 8) | m2,
        "vel_sign_b": (m3 >> 7) & 1,
        "vel_val_b": ((m3 & 0x7F) << 3) | (m4 >> 5),
        "vel_vr_source_baro": (m4 >> 4) & 1,
        "vel_vr_sign": (m4 >> 3) & 1,
        "vel_vr_val": ((m4 & 0x7) << 6) | (m5 >> 2),
        "vel_gbd_sign": (m6 >> 7) & 1,
        "vel_gbd_val": m6 & 0x7F,
    }
    return out


def callsign_to_str(codes: np.ndarray) -> str:
    """(8,) uint8 ASCII -> python str (host side)."""
    return bytes(np.asarray(codes, dtype=np.uint8)).decode("ascii")
