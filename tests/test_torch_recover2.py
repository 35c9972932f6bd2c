"""airjax_torch's 2-bit CRC repair (recover2) against airjax: the pair
table and its hashed form (the block-decode kernel's lookup, emulated in
torch), crc_check_and_recover2 and its scalar oracle, the DF17 and the
extended block decodes with recover2 (whole dicts, dtypes included; on
the CPU the block-decode wrapper runs its plain version), and the
extended assembly's pass 1.5. Inputs are made with numpy from seeds;
every output is compared exactly.

Frames carry 2-bit flips in bits 5-87 where the DF17 gate must still pass
(a flip in bits 0-4 fails the gate, so such a frame is never a
candidate); the extended decode takes flips anywhere, the DF field and
the CRC field included."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from airjax import extended as jext
from airjax import pipeline as jpipe
from airjax.dsp.magnitude import magnitude_u16 as j_magnitude_u16
from airjax.protocol import crc as jcrc
from airjax.track.icao_cache import IcaoCache as JCache
from airjax_torch import extended as text
from airjax_torch import pipeline as tpipe
from airjax_torch.dsp.magnitude import magnitude_u16
from airjax_torch.io import synth as tsynth
from airjax_torch.kernels import block_decode as kblock
from airjax_torch.protocol import crc as tcrc
from airjax_torch.protocol import shortframe
from airjax_torch.track.icao_cache import IcaoCache as TCache
from torch_parity import assert_same, assert_same_dict, packet_fields

ICAO = 0x7C6B30
FRAME = tsynth.make_df17(ICAO, tsynth.make_id_me("RECOVER2"))


def _flip_bits(frame: bytes, positions) -> bytes:
    b = bytearray(frame)
    for p in positions:
        b[p // 8] ^= 1 << (7 - p % 8)
    return bytes(b)


def test_pair_tables_equal_airjax():
    for want, got in zip(jcrc._pair_tables(), tcrc._pair_tables()):
        assert want.dtype == got.dtype
        np.testing.assert_array_equal(want, got)
    table = kblock.pair_hash_table()
    pair, pi, pj = jcrc._pair_tables()
    assert len(pair) == 3828 and table.dtype == np.uint32
    assert table.shape == (kblock.PAIR_BUCKETS, kblock.BUCKET_ENTRIES, 2)
    # The table holds exactly the pair syndromes, each with its own (i, j).
    keys, values = table[..., 0], table[..., 1]
    ij = {int(s): (int(i), int(j)) for s, i, j in zip(pair, pi, pj)}
    assert sorted(keys[keys != 0].tolist()) == sorted(ij)
    assert all(ij[int(s)] == (int(v) & 0xFF, int(v) >> 8) for s, v in zip(keys[keys != 0], values[keys != 0]))
    assert not values[keys == 0].any()


def test_pair_hash_table_places_every_pair_in_its_buckets():
    """Every airjax pair syndrome sits in bucket h1 or h2 of itself."""
    table = kblock.pair_hash_table()
    pair, pi, pj = jcrc._pair_tables()
    h1, h2 = kblock.pair_buckets(pair)
    for s, i, j, b1, b2 in zip(pair.tolist(), pi.tolist(), pj.tolist(), h1.tolist(), h2.tolist()):
        hits = [tuple(e) for b in {b1, b2} for e in table[b].tolist() if e[0] == s]
        assert hits == [(s, i | j << 8)], hex(s)


def test_pair_hash_table_misses_every_other_key():
    """The 88 single syndromes, 0 and 10,000 seeded random 24-bit deltas
    that are no pair syndrome find nothing in either bucket."""
    table = kblock.pair_hash_table()
    pair = set(jcrc._pair_tables()[0].tolist())
    rng = np.random.default_rng(11)
    others = [d for d in rng.integers(0, 1 << 24, 12_000).tolist() if d not in pair][:10_000]
    keys = np.concatenate([np.asarray(jcrc._tables()[1], np.int64), [0], others])
    assert len(keys) == 88 + 1 + 10_000
    assert (_lookup(torch.as_tensor(keys), table) == -1).all()


def test_pair_hash_table_is_the_same_on_every_call():
    first = kblock.pair_hash_table()
    assert all(np.array_equal(first, kblock.pair_hash_table()) for _ in range(2))


def _lookup(delta: torch.Tensor, table: np.ndarray) -> torch.Tensor:
    """The block-decode kernel's pair_of (csrc/candidate.cuh) in plain
    torch: both buckets of each delta (int64 hash), 8 keys compared ->
    i | j << 8, or -1."""
    t = torch.as_tensor(table.astype(np.int64))
    d = delta.to(torch.int64)
    h1, h2 = (((d * m) & 0xFFFFFFFF) >> kblock.HASH_SHIFT for m in kblock.HASH_MULTIPLIERS)
    entries = torch.cat([t[h1], t[h2]], dim=1)  # (N, 8, 2)
    hit = entries[..., 0] == d[:, None]
    return torch.where(hit.any(dim=1), (entries[..., 1] * hit).sum(dim=1), torch.full_like(d, -1))


def _flipped_rows(seed: int, n_flips: int) -> np.ndarray:
    """(N, 112) bits: seeded DF17 frames with n_flips distinct bits flipped
    anywhere (the CRC field included), and random rows."""
    rng = np.random.default_rng(seed)
    rows = [_flip_bits(tsynth.make_df17(int(rng.integers(1, 1 << 24)), tsynth.make_id_me(f"H{i:06d}")),
                       rng.choice(112, n_flips, replace=False)) for i in range(300)]
    bits = np.unpackbits(np.frombuffer(b"".join(rows), np.uint8)).reshape(-1, 112)
    return np.concatenate([bits, rng.integers(0, 2, (100, 112), dtype=np.uint8)])


@pytest.mark.parametrize("n_flips", [0, 1, 2, 3])
def test_hashed_lookup_equals_airjax_recover2(n_flips):
    """The single-bit repair, then the hashed pair lookup where the delta
    is nonzero and matched no single syndrome, equals airjax's
    crc_check_and_recover2 on every output."""
    bits = _flipped_rows(20 + n_flips, n_flips)
    want = jcrc.crc_check_and_recover2(jnp.asarray(bits))
    t_bits = torch.as_tensor(bits)
    tab = tcrc.tables("cpu")
    corrected, good, recovered = tcrc.crc_check_and_recover(t_bits, tab)
    delta = tcrc.crc24_batch(t_bits[:, :88], tab) ^ tcrc.pack_bits_msbfirst(t_bits[:, 88:], 24)
    ij = _lookup(delta, kblock.pair_hash_table())
    found2 = (ij >= 0) & ~good
    pos = torch.arange(112)
    flip = (pos == (ij & 0xFF)[:, None]) | (pos == (ij >> 8)[:, None])
    corrected = torch.where(found2[:, None], t_bits ^ flip.to(t_bits.dtype), corrected)
    for name, w, g in zip(("bits", "good", "recovered", "recovered2"), want,
                          (corrected, good | found2, recovered, found2)):
        assert_same(w, g, name)
    if n_flips == 2:
        assert int(found2.sum()) >= 150  # the ~62% of 300 whose two flips are both data bits


def _bit_rows(seed: int) -> np.ndarray:
    """(N, 112) bits: clean frames, 1-flips, 2-flips anywhere in the data
    bits (edges included), CRC-field flips, mixed, and random rows."""
    rng = np.random.default_rng(seed)
    frames = [tsynth.make_df17(int(rng.integers(1, 1 << 24)), tsynth.make_id_me(f"R{i:06d}")) for i in range(40)]
    rows = []
    for i, f in enumerate(frames):
        rows += [f, _flip_bits(f, [int(rng.integers(0, 88))]), _flip_bits(f, rng.choice(88, 2, replace=False)),
                 _flip_bits(f, [0, 87]), _flip_bits(f, rng.choice(np.arange(88, 112), 2, replace=False)),
                 _flip_bits(f, [int(rng.integers(0, 88)), int(rng.integers(88, 112))]),
                 _flip_bits(f, rng.choice(112, 3, replace=False))]
    bits = np.unpackbits(np.frombuffer(b"".join(rows), np.uint8)).reshape(-1, 112)
    return np.concatenate([bits, rng.integers(0, 2, (200, 112), dtype=np.uint8)])


@pytest.mark.parametrize("seed", [0, 1])
def test_crc_check_and_recover2_equals_airjax(seed):
    bits = _bit_rows(seed)
    want = jcrc.crc_check_and_recover2(jnp.asarray(bits))
    got = tcrc.crc_check_and_recover2(torch.as_tensor(bits), tcrc.tables("cpu"))
    for name, w, g in zip(("bits", "good", "recovered", "recovered2"), want, got):
        assert_same(w, g, name)
    assert int(np.sum(np.asarray(want[3]))) >= 80  # the 2-flips were repaired


def test_try_crc_recovery2_scalar_equals_airjax():
    rng = np.random.default_rng(5)
    rows = np.packbits(_bit_rows(2), axis=-1)
    for row in rows[rng.choice(len(rows), 60, replace=False)]:
        frame = row.tobytes()
        assert tcrc.try_crc_recovery2_scalar(frame) == jcrc.try_crc_recovery2_scalar(frame)
    assert tcrc.try_crc_recovery2_scalar(_flip_bits(FRAME, [9, 70])) == FRAME


def _df17_capture(seed: int, n: int):
    """DF17 frames every 301 samples from offset 0: clean, 1-flip and 2-flip
    in bits 5-87, 3-bit bursts and CRC-field flips; a 2-flip at offset 0 so
    that the empty slots carry its pair repair."""
    rng = np.random.default_rng(seed)
    sent = []
    for i in range(n):
        f = tsynth.make_df17(int(rng.integers(1, 1 << 24)), tsynth.make_id_me(f"DF{i:06d}"))
        kind = 2 if i == 0 else i % 5
        if kind == 1:
            f = _flip_bits(f, [int(rng.integers(5, 88))])
        elif kind == 2:
            f = _flip_bits(f, rng.choice(np.arange(5, 88), 2, replace=False))
        elif kind == 3:
            f = _flip_bits(f, rng.choice(np.arange(5, 112), 3, replace=False))
        elif kind == 4:
            f = _flip_bits(f, rng.choice(np.arange(88, 112), 2, replace=False))
        sent.append(f)
    offs = list(np.arange(n) * 301)
    return tsynth.modulate(sent, offs, n * 301 + 400, seed=seed)


@pytest.mark.parametrize("seed,n,capacity", [(3, 30, 64), (4, 30, 16), (5, 12, 8)])
def test_decode_r2_equals_airjax(seed, n, capacity):
    """decode_iq_block_r2 and decode_mags_block(recover2=True) against
    airjax's decode_iq_block_r2, capacity above and below the total."""
    iq = _df17_capture(seed, n)
    n_off = len(iq) - 240
    want = jax.device_get(jpipe.decode_iq_block_r2(jnp.asarray(iq), n_off, capacity))
    t_iq = torch.as_tensor(iq)
    assert_same_dict(want, tpipe.decode_iq_block_r2(t_iq, n_off, capacity))
    assert_same_dict(want, tpipe.decode_mags_block(magnitude_u16(t_iq), n_off, capacity, recover2=True))
    assert "recovered2" in want and int(np.sum(want["recovered2"])) > 0
    # Without recover2 the dict is the one it always was.
    assert_same_dict(jax.device_get(jpipe.decode_iq_block(jnp.asarray(iq), n_off, capacity)),
                     tpipe.decode_iq_block(t_iq, n_off, capacity))


def _mixed_capture(seed: int, n_aircraft: int):
    """Every downlink format; a quarter of the frames with a 2-bit flip
    anywhere (DF field included), some 1-flips and CRC-field flips, and
    every second aircraft's DF17 with a 2-bit flip past its DF field (its
    DF11 squitter seeds the cache, so assembly accepts the repair)."""
    rng = np.random.default_rng(seed)
    frames = tsynth.make_mixed_frames(n_aircraft, seed)
    for i, f in enumerate(frames):
        nbits = 8 * len(f)
        if i % 20 == 10:
            frames[i] = _flip_bits(f, rng.choice(np.arange(5, 88), 2, replace=False))
        elif i % 4 == 1:
            frames[i] = _flip_bits(f, rng.choice(nbits, 2, replace=False))
        elif i % 4 == 2:
            frames[i] = _flip_bits(f, [int(rng.integers(0, nbits))])
        elif i % 8 == 3:
            frames[i] = _flip_bits(f, rng.choice(np.arange(nbits - 24, nbits), 2, replace=False))
    offs = list(np.arange(len(frames)) * 301 + 3)
    return tsynth.modulate(frames, offs, len(frames) * 301 + 500, seed=seed)


@pytest.mark.parametrize("seed,n_aircraft,capacity", [(6, 3, 256), (7, 4, 24)])
def test_extended_r2_equals_airjax(seed, n_aircraft, capacity):
    iq = _mixed_capture(seed, n_aircraft)
    n_off = len(iq) - 240
    want = jax.device_get(jpipe.decode_iq_block_extended(jnp.asarray(iq), n_off, capacity, True))
    t_iq = torch.as_tensor(iq)
    got = tpipe.decode_iq_block_extended(t_iq, n_off, capacity, recover2=True)
    assert_same_dict(want, got)
    assert_same_dict(want, tpipe.decode_mags_block_extended(magnitude_u16(t_iq), n_off, capacity, recover2=True))
    # The pair flips land in `frames` whatever the DF; frames_raw stays raw.
    assert not np.array_equal(want["frames"], want["frames_raw"])


def test_extended_r2_golden_frame_and_assembly_gate():
    """airjax's extended recover2 cases: a repaired DF17 of a cached ICAO
    emits (pass 1.5), a stranger's never does and never seeds the cache."""
    stranger = tsynth.make_df17(0x123456, tsynth.make_id_me("STRANGER"))
    frames = [FRAME, _flip_bits(FRAME, [9, 55]), _flip_bits(stranger, [9, 55]), shortframe.make_df4(0x123456, 9000)]
    iq = tsynth.modulate(frames, [500, 3000, 6000, 9000], 20000, seed=9)
    want = jax.device_get(jpipe.decode_iq_block_extended(jnp.asarray(iq), 20000 - 240, 128, True))
    got = tpipe.to_host(tpipe.decode_iq_block_extended(torch.as_tensor(iq), 20000 - 240, 128, recover2=True))
    assert_same_dict(want, got)
    j_pkts = jext.assemble_extended(want, 100.0, JCache())
    t_pkts = text.assemble_extended(got, 100.0, TCache())
    assert [(o, packet_fields(p)) for o, p in t_pkts] == [(o, packet_fields(p)) for o, p in j_pkts]
    assert [(o, p.icao) for o, p in t_pkts] == [(500, ICAO), (3000, ICAO)]


@pytest.mark.parametrize("seed", [6, 7])
def test_assemble_extended_recover2_equals_airjax(seed):
    iq = _mixed_capture(seed, 4)
    n_off = len(iq) - 240
    want = jax.device_get(jpipe.decode_mags_block_extended(j_magnitude_u16(jnp.asarray(iq)), n_off, 256, True))
    got = tpipe.to_host(tpipe.decode_iq_block_extended(torch.as_tensor(iq), n_off, 256, recover2=True))
    j_pkts = jext.assemble_extended(want, 50.0, JCache())
    t_pkts = text.assemble_extended(got, 50.0, TCache())
    assert [(o, packet_fields(p)) for o, p in t_pkts] == [(o, packet_fields(p)) for o, p in j_pkts]
    assert sum(bool(r) for r in want["recovered2"]) > 0 and len(t_pkts) > 0
