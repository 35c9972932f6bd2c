"""airjax_torch.protocol.crc and the candidate stage against airjax:
tables, scalar CRC, the batched check and repair, and the plain candidate
chain (slice_bits_packed -> crc_check_and_recover -> bits_to_bytes). The
candidate kernel itself is compared with its plain version on the card
(tests/test_torch_cuda.py)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from airjax.dsp.demod import slice_bits_packed as jax_slice_bits_packed
from airjax.protocol import crc as jcrc
from airjax_torch.io import synth
from airjax_torch.kernels import candidate as candidate_mod
from airjax_torch.kernels.candidate import decode_candidates
from airjax_torch.protocol import crc as tcrc
from torch_parity import assert_same


def test_tables_equal_airjax():
    m_j, s_j = jcrc._tables()
    m_t, s_t = tcrc._tables()
    assert m_t.dtype == m_j.dtype and s_t.dtype == s_j.dtype
    np.testing.assert_array_equal(m_t, m_j)
    np.testing.assert_array_equal(s_t, s_j)
    assert len(np.unique(s_t)) == tcrc.DATA_BITS  # the repair's uniqueness


def test_public_tables_equal_airjax():
    """crc_matrix() and syndromes(): airjax's arrays, element for element,
    with airjax's dtypes."""
    for ours, theirs in ((tcrc.crc_matrix(), jcrc.crc_matrix()), (tcrc.syndromes(), jcrc.syndromes())):
        assert isinstance(ours, np.ndarray) and ours.dtype == theirs.dtype and ours.shape == theirs.shape
        np.testing.assert_array_equal(ours, theirs)
    assert tcrc.crc_matrix().shape == (88, 24) and tcrc.syndromes().dtype == np.uint32


@pytest.mark.parametrize("kind", ["bytes", "bytearray", "one", "batch", "batch3"])
def test_bytes_to_bits_equals_airjax(kind):
    rng = np.random.default_rng(len(kind))
    arr = rng.integers(0, 256, size={"one": (14,), "batch": (9, 14), "batch3": (2, 3, 14)}.get(kind, (14,)),
                       dtype=np.uint8)
    arg = {"bytes": bytes(arr), "bytearray": bytearray(arr)}.get(kind, arr)
    ours, theirs = tcrc.bytes_to_bits(arg), jcrc.bytes_to_bits(arg)
    assert ours.dtype == theirs.dtype == np.uint8 and ours.shape == theirs.shape == arr.shape[:-1] + (112,)
    np.testing.assert_array_equal(ours, theirs)
    np.testing.assert_array_equal(tcrc.bits_to_bytes(torch.as_tensor(ours)).numpy(), arr)


def test_load_tables_round_trips():
    tab = tcrc.load_tables(*jcrc._tables(), device="cpu")
    assert tab.matrix.dtype == torch.float32 and tab.syndromes.dtype == torch.int32
    np.testing.assert_array_equal(tab.matrix.numpy().astype(np.uint8), jcrc._tables()[0])
    np.testing.assert_array_equal(tab.syndromes.numpy().astype(np.uint32), jcrc._tables()[1])
    own = tcrc.tables("cpu")
    assert torch.equal(own.matrix, tab.matrix) and torch.equal(own.syndromes, tab.syndromes)


def test_scalar_crc24_matches_airjax():
    rng = np.random.default_rng(4)
    for n in (3, 7, 11, 11, 11):
        data = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        assert tcrc.crc24(data) == jcrc.crc24(data)


def _frames_with_flips(rng) -> list[bytes]:
    base = [synth.make_df17(int(rng.integers(0, 1 << 24)), synth.make_id_me(f"CRC{i:03d}")) for i in range(40)]
    out = list(base)
    out += [synth.flip_bit(f, int(rng.integers(0, 88))) for f in base]  # repairable
    out += [synth.flip_bit(f, int(rng.integers(88, 112))) for f in base]  # CRC field: never
    out += [synth.flip_bit(synth.flip_bit(f, 3), 50) for f in base[:10]]  # two flips
    out += [rng.integers(0, 256, 14, dtype=np.uint8).tobytes() for _ in range(20)]
    return out


def test_crc_check_and_recover_matches_airjax():
    rng = np.random.default_rng(9)
    frames = _frames_with_flips(rng)
    bits = np.unpackbits(np.frombuffer(b"".join(frames), np.uint8)).reshape(-1, 112)
    c_j, g_j, r_j = jcrc.crc_check_and_recover(jnp.asarray(bits))
    tab = tcrc.load_tables(*jcrc._tables(), device="cpu")
    c_t, g_t, r_t = tcrc.crc_check_and_recover(torch.as_tensor(bits), tab)
    assert_same(np.asarray(c_j), c_t, "corrected")
    assert_same(np.asarray(g_j), g_t, "good")
    assert_same(np.asarray(r_j), r_t, "recovered")
    assert_same(np.asarray(jcrc.bits_to_bytes(c_j)), tcrc.bits_to_bytes(c_t), "bytes")
    assert_same(np.asarray(jcrc.crc24_batch(jnp.asarray(bits[:, :88]))).astype(np.int32),
                tcrc.crc24_batch(torch.as_tensor(bits[:, :88]), tab), "crc")
    assert int(r_t.sum()) == 40 and int(g_t.sum()) == 80


@pytest.mark.parametrize("fn", ["crc24_batch", "crc_check_and_recover", "crc_check_and_recover2"])
def test_crc_needs_no_tables_as_airjax(fn):
    """airjax's call, with no tables: the port takes its own on the bits'
    device, the same result as with tables("cpu") passed, and airjax's."""
    frames = _frames_with_flips(np.random.default_rng(16))
    bits = np.unpackbits(np.frombuffer(b"".join(frames), np.uint8)).reshape(-1, 112)
    if fn == "crc24_batch":
        bits = bits[:, :88]
    ours = getattr(tcrc, fn)(torch.as_tensor(bits))
    with_tables = getattr(tcrc, fn)(torch.as_tensor(bits), tcrc.tables("cpu"))
    theirs = getattr(jcrc, fn)(jnp.asarray(bits))
    for o, w, t in zip(*(r if isinstance(r, tuple) else (r,) for r in (ours, with_tables, theirs)), strict=True):
        assert torch.equal(o, w)
        assert_same(np.asarray(t).astype(np.int32) if fn == "crc24_batch" else np.asarray(t), o, fn)


def _candidate_case(kind: str, seed: int):
    """Packed words and candidate offsets, shaped like one decoded block."""
    rng = np.random.default_rng(seed)
    n = 30000
    if kind == "random":
        words = rng.integers(0, 1 << 32, n // 32 + 8, dtype=np.uint32)
        offsets = rng.integers(0, n - 240, 300).astype(np.int32)
    else:
        from airjax_torch.dsp.demod import pack_cmp_words
        from airjax_torch.dsp.magnitude import magnitude_u16

        frames = _frames_with_flips(rng)[:100]
        offs = np.arange(len(frames)) * 297 + int(rng.integers(0, 31))
        iq = synth.modulate(frames, list(offs), n, noise_std=60.0, seed=seed)
        words = pack_cmp_words(magnitude_u16(torch.as_tensor(iq))).numpy().view(np.uint32)
        offsets = np.concatenate([offs, [0, 0, n - 240]]).astype(np.int32)
    return words, offsets


@pytest.mark.parametrize("kind", ["frames", "random"])
def test_plain_candidates_match_airjax_chain(kind):
    words, offsets = _candidate_case(kind, 3)
    bits = jax_slice_bits_packed(jnp.asarray(words), jnp.asarray(offsets))
    c_j, g_j, r_j = jcrc.crc_check_and_recover(bits)
    frames, crc_ok, recovered = decode_candidates(
        torch.as_tensor(words.view(np.int32)), torch.as_tensor(offsets)
    )
    assert_same(np.asarray(jcrc.bits_to_bytes(c_j)), frames, "frames")
    assert_same(np.asarray(g_j), crc_ok, "crc_ok")
    assert_same(np.asarray(r_j), recovered, "recovered")
    if kind == "frames":
        assert int(recovered.sum()) > 0 and int(crc_ok.sum()) > int(recovered.sum())


def test_candidate_wrapper_checks_and_counts():
    words, offsets = _candidate_case("random", 1)
    w, o = torch.as_tensor(words.view(np.int32)), torch.as_tensor(offsets)
    before = candidate_mod.launches
    decode_candidates(w, o)
    assert candidate_mod.launches == before  # CPU: plain version, no launch
    with pytest.raises(ValueError):
        decode_candidates(w.to(torch.int64), o)
    with pytest.raises(ValueError):
        decode_candidates(w, o.to(torch.int64))
    with pytest.raises(ValueError):
        decode_candidates(w, o.to("meta"))
