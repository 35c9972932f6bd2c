"""airjax_torch's batched protocol fields against airjax: extract_fields,
extract_short_fields(_from_raw) and callsign_to_str on random rows that
take every byte value, the fields kernel's wrapper on the CPU (its plain
version), and the whole `_with_fields` dicts of both decodes, with and
without recover2, also through the block-decode wrapper's fields=True
(the kernel's F flag; on the CPU its plain version). Inputs are made with numpy from seeds; every output is
compared exactly, dtypes included (airjax's uint32 fields as int32)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from airjax import pipeline as jpipe
from airjax.protocol import fields as jfields
from airjax.protocol import shortframe as jshort
from airjax_torch import pipeline as tpipe
from airjax_torch.io import synth as tsynth
from airjax_torch.kernels import fields as kfields
from airjax_torch.kernels.block_decode import decode_block_bits
from airjax_torch.kernels.magdet import magdet_bits
from airjax_torch.protocol import fields as tfields
from airjax_torch.protocol import shortframe as tshort
from torch_parity import assert_same_dict


def _rows(seed: int, n: int) -> np.ndarray:
    """(n, 14) uint8: random bytes, every byte value in every column, and
    real frames of each kind the trackers see."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, 256, (n, 14), dtype=np.uint8)
    rows[:256] = np.arange(256, dtype=np.uint8)[:, None]
    made = [
        tsynth.make_df17(0x4840D6, tsynth.make_id_me("KLM1023")),
        tsynth.make_df17(0x4840D6, tsynth.make_position_me(11, 38000, 93000, 51372, True, q25=False)),
        tsynth.make_df17(0x4840D6, tsynth.make_velocity_me(-120, 300, -640)),
        tsynth.make_df18(0xABCDEF, tsynth.make_velocity_me(heading_deg=90.0, airspeed_kt=250, subtype=3), cf=6),
        tshort.make_df4(0x123456, 9000, gillham=True) + bytes(7),
        tshort.make_df5(0x123456, 7700) + bytes(7),
        tshort.make_df0(0x123456, 12300, vs=1, gillham=True) + bytes(7),
    ]
    rows[256 : 256 + len(made)] = np.frombuffer(b"".join(made), np.uint8).reshape(-1, 14)
    return rows


@pytest.mark.parametrize("seed,n", [(0, 300), (1, 1500)])
def test_extract_fields_equals_airjax(seed, n):
    rows = _rows(seed, n)
    want = jfields.extract_fields(jnp.asarray(rows))
    assert_same_dict(want, tfields.extract_fields(torch.as_tensor(rows)))
    # Any batch shape, as airjax's (..., 14).
    assert_same_dict(jfields.extract_fields(jnp.asarray(rows[:300].reshape(3, 100, 14))),
                     tfields.extract_fields(torch.as_tensor(rows[:300].reshape(3, 100, 14))))
    codes = np.asarray(want["callsign_codes"])
    assert all(tfields.callsign_to_str(c) == jfields.callsign_to_str(c) for c in codes[:300])
    assert tfields.callsign_to_str(codes[256]) == "KLM1023_"


@pytest.mark.parametrize("seed,n", [(2, 300), (3, 3000)])
def test_extract_short_fields_equals_airjax(seed, n):
    rows = _rows(seed, n)
    want = jshort.extract_short_fields_from_raw(jnp.asarray(rows))
    assert_same_dict(want, tshort.extract_short_fields_from_raw(torch.as_tensor(rows)))
    bits = np.unpackbits(rows[:, :7], axis=-1)
    assert_same_dict(jshort.extract_short_fields(jnp.asarray(bits)),
                     tshort.extract_short_fields(torch.as_tensor(bits)))
    # Every AC13 code: altitude, altitude_valid (Gillham 7 <-> 5, reflection) and squawk.
    ac = np.arange(1 << 13, dtype=np.int64)
    words = (4 << 27) | ac
    raw = np.zeros((len(ac), 7), np.uint8)
    raw[:, :4] = (words[:, None] >> np.array([24, 16, 8, 0])) & 0xFF
    assert_same_dict(jshort.extract_short_fields_from_raw(jnp.asarray(raw)),
                     tshort.extract_short_fields_from_raw(torch.as_tensor(raw)))


@pytest.mark.parametrize("extended", [False, True])
@pytest.mark.parametrize("k", [0, 1, 777])
def test_block_fields_wrapper_on_cpu(extended, k):
    """The fields kernel's wrapper runs its plain version on the CPU: the
    same dicts as airjax's extractions, under their keys and dtypes."""
    rows = _rows(4, max(k, 300))[:k]
    raw = _rows(5, max(k, 300))[:k]
    fields, short = kfields.block_fields(torch.as_tensor(rows), torch.as_tensor(raw) if extended else None)
    assert_same_dict(jfields.extract_fields(jnp.asarray(rows)), fields)
    if extended:
        assert_same_dict(jshort.extract_short_fields_from_raw(jnp.asarray(raw)), short)
    else:
        assert short is None
    assert kfields.LONG_ROWS == tuple(k for k in jfields.extract_fields(jnp.asarray(rows[:1]))
                                      if k not in ("alt_mode_25", "callsign_codes"))
    assert kfields.SHORT_ROWS == tuple(k for k in jshort.extract_short_fields_from_raw(jnp.asarray(raw[:1]))
                                       if k != "altitude_valid")


def test_block_fields_rejects_bad_input():
    with pytest.raises(ValueError):
        kfields.block_fields(torch.zeros((4, 13), dtype=torch.uint8))
    with pytest.raises(ValueError):
        kfields.block_fields(torch.zeros((4, 14), dtype=torch.int32))
    with pytest.raises(ValueError):
        kfields.block_fields(torch.zeros((4, 14), dtype=torch.uint8), torch.zeros((5, 14), dtype=torch.uint8))


def _capture(seed: int):
    """Position, ID and velocity squitters and every short format, some
    DF17s with 1- and 2-bit flips past the DF field."""
    rng = np.random.default_rng(seed)
    frames = tsynth.make_mixed_frames(3, seed)
    for i in range(12):
        lat, lon = tsynth.encode_airborne_cpr(52.0 + i / 10, 4.0 + i / 7, bool(i % 2))
        me = (tsynth.make_position_me(11, 30000 + 100 * i, lat, lon, bool(i % 2)) if i % 3 == 0
              else tsynth.make_velocity_me(100 + i, -50, 64 * i) if i % 3 == 1 else tsynth.make_id_me(f"FLD{i}"))
        f = tsynth.make_df17(0x300000 + i % 4, me)
        if i % 4 == 1:
            f = tsynth.flip_bit(f, int(rng.integers(5, 88)))
        elif i % 4 == 2:
            f = tsynth.flip_bit(tsynth.flip_bit(f, 20), 70)
        frames.append(f)
    offs = list(np.arange(len(frames)) * 301 + 11)
    return tsynth.modulate(frames, offs, len(frames) * 301 + 500, seed=seed)


@pytest.mark.parametrize("recover2", [False, True])
@pytest.mark.parametrize("capacity", [16, 128])
def test_with_fields_dicts_equal_airjax(recover2, capacity):
    iq = _capture(8)
    n_off = len(iq) - 240
    t_iq = torch.as_tensor(iq)
    want = jax.device_get(jpipe.decode_iq_block_with_fields(jnp.asarray(iq), n_off, capacity, recover2))
    got = tpipe.to_host(tpipe.decode_iq_block_with_fields(t_iq, n_off, capacity, recover2))
    _same_nested(want, got)
    bits = magdet_bits(t_iq, n_off)
    _same_nested(want, tpipe.to_host(decode_block_bits(*bits, n_off, capacity, recover2=recover2, fields=True)))

    want = jax.device_get(jpipe.decode_iq_block_extended_with_fields(jnp.asarray(iq), n_off, 4 * capacity, recover2))
    got = tpipe.to_host(tpipe.decode_iq_block_extended_with_fields(t_iq, n_off, 4 * capacity, recover2))
    _same_nested(want, got)
    bits = magdet_bits(t_iq, n_off, "preamble")
    _same_nested(want, tpipe.to_host(decode_block_bits(*bits, n_off, 4 * capacity, extended=True, recover2=recover2,
                                                       fields=True)))


def _same_nested(want: dict, got: dict) -> None:
    """A `_with_fields` dict: its field dicts and the rest, key by key."""
    want, got = dict(want), dict(got)
    assert sorted(want) == sorted(got)
    for key in ("fields", "short_fields"):
        if key in want:
            assert_same_dict(want.pop(key), got.pop(key))
    assert_same_dict(want, got)
