"""ADS-B field constants shared by the host packet model and the synthetic
frame makers (airjax/protocol/fields.py:23-33).

The batched device field extraction of that module (`extract_fields`) is
not ported yet: it feeds the batched sinks.
"""

from __future__ import annotations

import numpy as np

# src/adsb/msgs.rs:172-177
CHAR_CONVERT = (
    "#ABCDEFGHIJKLMNOPQRSTUVWXYZ#####_###############0123456789######"
)
_CHAR_TABLE = np.frombuffer(CHAR_CONVERT.encode("ascii"), dtype=np.uint8)

MSG_UNKNOWN = 0
MSG_AIRCRAFT_ID = 1
MSG_AIRCRAFT_POSITION = 2
# Extension class (extended mode): the reference leaves TC19 Unknown.
MSG_AIRCRAFT_VELOCITY = 3
