"""airjax_torch.parallel (mesh, halo) and the shard-gather kernel's plain
version against airjax.parallel on the CPU: airjax on its 8-device CPU
mesh (tests/conftest.py), the port on a mesh of 8 CPU shards. The cases
of tests/test_sharding.py, test_sharding_extended.py and
test_compact_gather.py (less the multihost ones): the hits or packets and
the whole stats dict equal airjax's, with both gathers; the tolerance is
0. The shard gather is also held to airjax's own composition
(_compact_local, _global_base, _scatter_to_global in a shard_map) on
random shard outputs."""

import dataclasses
import enum

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec

from airjax.config import PipelineConfig as JConfig
from airjax.io import synth
from airjax.parallel import halo as jhalo
from airjax.parallel.mesh import make_mesh as jmake_mesh
from airjax.pipeline import decode_capture_overlap as jdecode_capture_overlap
from airjax.protocol import shortframe
from airjax.track.icao_cache import IcaoCache as JIcaoCache
from airjax_torch import pipeline
from airjax_torch.config import PipelineConfig
from airjax_torch.kernels import shard_gather as sg
from airjax_torch.parallel import halo
from airjax_torch.parallel.mesh import Mesh, make_mesh
from airjax_torch.track.icao_cache import IcaoCache
from torch_parity import airjax_builders_cached, assert_same_dict

ICAO = 0x7C6B30
ID_FRAME = synth.make_df17(ICAO, synth.make_id_me("ANZ128"))
POS_FRAME = synth.make_df17(ICAO, synth.make_position_me(tc=11, altitude_ft=5000, cpr_lat=12345, cpr_lon=54321,
                                                         odd=True))
DF17 = synth.make_df17(ICAO, synth.make_id_me("SHRDEXT"))
DF11 = shortframe.make_df11(ICAO, capability=5)
DF4 = shortframe.make_df4(ICAO, altitude_ft=12000)
DF5 = shortframe.make_df5(ICAO, squawk=7421)


@pytest.fixture(scope="module", autouse=True)
def _airjax_steps_once():
    """Each airjax step shape jit-compiles once in this module."""
    with airjax_builders_cached():
        yield


@pytest.fixture(scope="module")
def meshes():
    assert len(jax.devices()) >= 8, "conftest should provide 8 virtual devices"
    return jmake_mesh(8), make_mesh(8, "cpu")


def packets(pkts) -> list:
    """[(offset, packet)] of either package as (offset, class, fields)."""

    def factory(items):
        return {k: (v.name if isinstance(v, enum.Enum) else v) for k, v in items}

    return [(o, type(p).__name__, dataclasses.asdict(p, dict_factory=factory)) for o, p in pkts]


def both(meshes, iq, extended=False, **kw):
    """The capture through airjax's and the port's sharded decode -> (airjax's, port's)."""
    jmesh, tmesh = meshes
    if extended:
        return (jhalo.decode_capture_sharded_extended(iq, jmesh, now=100.0, **kw),
                halo.decode_capture_sharded_extended(iq, tmesh, now=100.0, **kw))
    return jhalo.decode_capture_sharded(iq, jmesh, **kw), halo.decode_capture_sharded(iq, tmesh, **kw)


def assert_equal_decodes(want, got, extended=False):
    if extended:
        assert packets(got[0]) == packets(want[0])
    else:
        assert got[0] == want[0]
    assert got[1] == want[1]


# ---- test_sharding.py ----------------------------------------------------


@pytest.mark.parametrize("gather", ["compact", "dense"])
def test_sharded_matches_single_device(meshes, gather):
    n = 32000
    shard = n // 8
    offsets = [100, shard - 120, shard + 130, 3 * shard - 200, 5 * shard - 10, n - 300]
    frames = [ID_FRAME, POS_FRAME, ID_FRAME, POS_FRAME, ID_FRAME, POS_FRAME]
    iq = synth.modulate(frames, offsets, n, seed=11)
    want, got = both(meshes, iq, gather=gather)
    assert_equal_decodes(want, got)
    single, _ = pipeline.decode_capture_overlap(iq, PipelineConfig(block_len=n), device="cpu")
    assert [(h[1], h[2]) for h in got[0]] == [(h[1], h[2]) for h in single]
    assert {(h[1], h[2]) for h in got[0]} >= set(zip(offsets, frames))


def test_boundary_straddle_across_shards(meshes):
    n = 32000
    offsets = [b * (n // 8) - 120 for b in range(1, 8)]
    iq = synth.modulate([ID_FRAME] * len(offsets), offsets, n, seed=12)
    want, got = both(meshes, iq)
    assert_equal_decodes(want, got)
    assert {h[1] for h in got[0] if h[2] == ID_FRAME} >= set(offsets)


def test_tail_mask(meshes):
    # No hit from the last shard's wrapped halo.
    n = 16000
    iq = synth.modulate([ID_FRAME], [50], n, seed=13)
    want, got = both(meshes, iq)
    assert_equal_decodes(want, got)
    assert all(h[1] <= n - 240 for h in got[0]) and any(h[1] == 50 for h in got[0])


def test_tuned_block_math():
    assert (halo.HALO, halo.TUNED_HALO, halo.TUNED_RESIDUE) == (jhalo.HALO, jhalo.TUNED_HALO, jhalo.TUNED_RESIDUE)
    for per in (1, 239, 1000, 4095, 4096, 6000, 1 << 20, (1 << 22) - 240, 1 << 22, (1 << 24) + 7):
        b = halo.tuned_block(per)
        assert b == jhalo.tuned_block(per)
        assert halo._halo_size(b) == jhalo._halo_size(b)
        if per >= 4096:
            assert b % 1024 == 784 and b - per < 1024 and (b + halo._halo_size(b)) % 1024 == 0


@pytest.mark.parametrize("extended", [False, True])
def test_tuned_decomposition_matches_single_device(meshes, extended):
    n = 48000
    block = halo.tuned_block(-(-n // 8))
    assert block == 6928
    if extended:
        offsets, frames = [300, block - 60, 3 * block - 120, n - 500], [DF11, DF4, DF17, DF5]
    else:
        offsets = [100, block - 120, 3 * block - 200, 5 * block - 10, n - 300]
        frames = [ID_FRAME, POS_FRAME, ID_FRAME, POS_FRAME, ID_FRAME]
    iq = synth.modulate(frames, offsets, n, seed=34 if extended else 21)
    want, got = both(meshes, iq, extended=extended)
    assert_equal_decodes(want, got, extended)
    if extended:
        assert {o for o, _ in got[0]} >= set(offsets)
    else:
        single, _ = jdecode_capture_overlap(iq, JConfig(block_len=n))
        assert [(h[1], h[2]) for h in got[0]] == [(h[1], h[2]) for h in single]


# ---- test_sharding_extended.py ---------------------------------------------


@pytest.mark.parametrize("gather", ["compact", "dense"])
def test_extended_sharded_matches_single_device(meshes, gather):
    n = 32000
    shard = n // 8
    placements = [(DF11, 300), (DF17, 1200), (DF4, shard - 60), (DF5, 2 * shard - 60), (DF4, 3 * shard + 500),
                  (DF17, 5 * shard - 120), (DF5, 6 * shard + 700), (DF11, n - 400)]
    iq = synth.modulate([f for f, _ in placements], [o for _, o in placements], n, seed=31)
    want, got = both(meshes, iq, extended=True, gather=gather)
    assert_equal_decodes(want, got, extended=True)
    # The whole capture as one extended block: the same packets.
    out = pipeline.to_host(pipeline.decode_iq_block_extended(torch.as_tensor(iq), n - 240, 256))
    from airjax_torch.extended import assemble_extended

    assert packets(got[0]) == packets(assemble_extended(out, 100.0, IcaoCache()))
    assert {o for o, _ in got[0]} >= {o for _, o in placements}
    assert got[1]["n_good_long"] >= 2 and got[1]["n_good_df11"] >= 2


def test_extended_sharded_ap_gating_is_global(meshes):
    # The DF11 in shard 0 unlocks the AP-addressed DF4 in shard 7; alone, the DF4 stays gated.
    n = 32000
    shard = n // 8
    want, got = both(meshes, synth.modulate([DF11, DF4], [100, 7 * shard + 500], n, seed=32), extended=True)
    assert_equal_decodes(want, got, extended=True)
    assert {"AllCallReply", "SurveillanceReply"} <= {type(p).__name__ for _, p in got[0]}
    want, got = both(meshes, synth.modulate([DF4], [7 * shard + 500], n, seed=33), extended=True)
    assert_equal_decodes(want, got, extended=True)
    assert not got[0]


# ---- test_compact_gather.py ------------------------------------------------


def _capture(n_dev, block):
    """Frames inside shards and straddling every shard edge."""
    n = block * n_dev
    frame = synth.make_df17(ICAO, synth.make_id_me("COMPACT"))
    offsets = [37 + 500 * i for i in range(6)] + [b * block - 100 for b in range(1, n_dev)]
    return synth.modulate([frame] * len(offsets), offsets, n, seed=3), offsets


def test_compact_equals_dense_parity(meshes):
    iq, offsets = _capture(8, halo.tuned_block(16384))
    want_d, got_d = both(meshes, iq, capacity_per_shard=64, gather="dense")
    want_c, got_c = both(meshes, iq, capacity_per_shard=64, gather="compact")
    assert_equal_decodes(want_d, got_d)
    assert_equal_decodes(want_c, got_c)
    assert got_c[0] == got_d[0] and sorted(h[1] for h in got_c[0]) == sorted(offsets)
    assert got_c[1]["fetched_bytes"] == len(offsets) * (4 + 4 + 14) < got_d[1]["fetched_bytes"] / 10


def test_compact_rows_are_offset_sorted(meshes):
    iq, _ = _capture(8, halo.tuned_block(16384))
    step = halo.build_sharded_decoder_compact(meshes[1], len(iq), 256, 256)
    out = pipeline.to_host(step(iq))
    n = int(out["n_good"])
    assert n == 13 and list(out["offsets"][:n]) == sorted(out["offsets"][:n])
    # The rows past n_good are zero, as airjax's psum leaves them.
    assert not out["offsets"][n:].any() and not out["frames"][n:].any() and not out["recovered"][n:].any()


@pytest.mark.parametrize("extended", [False, True])
def test_compact_overflow_regrows(meshes, extended):
    # K = 2 for 6 frames in shard 0 and C = 4 < n_good: both regrow.
    iq, offsets = _capture(8, halo.tuned_block(16384))
    want, got = both(meshes, iq, extended=extended, capacity_per_shard=2, compact_capacity=4, gather="compact")
    assert_equal_decodes(want, got, extended)
    if not extended:
        assert sorted(h[1] for h in got[0]) == sorted(offsets)
    assert got[1]["capacity_per_shard"] > 2 and got[1]["compact_capacity"] > 4


def test_compact_equals_dense_extended(meshes):
    block = halo.tuned_block(16384)
    df24 = shortframe.make_df24(ICAO, nd=2, md=bytes(range(10)), ke=1)
    frame = synth.make_df17(ICAO, synth.make_id_me("COMPACT"))
    iq = synth.modulate([DF11, DF4, frame, df24, frame], [200, block - 60, 2000, 3200, 2 * block - 100], block * 8,
                        seed=1)
    want_d, got_d = both(meshes, iq, extended=True, gather="dense")
    want_c, got_c = both(meshes, iq, extended=True, gather="compact")
    assert_equal_decodes(want_d, got_d, extended=True)
    assert_equal_decodes(want_c, got_c, extended=True)
    assert packets(got_c[0]) == packets(got_d[0])
    assert got_c[1]["n_candidates"] < 200 and got_c[1]["fetched_bytes"] == got_c[1]["n_candidates"] * 45


def test_compact_extended_fuzz_vs_dense(meshes):
    """A random frame soup, capture after capture: compact == dense ==
    airjax, each with a fresh ICAO cache."""
    rng = np.random.default_rng(7)
    block = halo.tuned_block(16384)
    n = block * 8
    kinds = [synth.make_df17(ICAO, synth.make_id_me("FUZZCMP")), DF11, shortframe.make_df4(ICAO, altitude_ft=9000)]
    for it in range(3):
        offsets = np.sort(rng.choice(np.arange(1, (n - 400) // 400) * 400, int(rng.integers(3, 12)),
                                     replace=False)).tolist()
        frames = [kinds[int(rng.integers(len(kinds)))] for _ in offsets]
        iq = synth.modulate(frames, offsets, n, noise_std=30.0, seed=100 + it)
        want = jhalo.decode_capture_sharded_extended(iq, meshes[0], now=50.0, cache=JIcaoCache())
        dense = halo.decode_capture_sharded_extended(iq, meshes[1], now=50.0, cache=IcaoCache(), gather="dense")
        compact = halo.decode_capture_sharded_extended(iq, meshes[1], now=50.0, cache=IcaoCache())
        assert packets(compact[0]) == packets(dense[0]) == packets(want[0]), f"iter {it}"
        assert compact[1] == want[1]


# ---- the port's own: the recover2 and fields steps, the mesh ---------------


@pytest.mark.parametrize("extended", [False, True])
def test_compact_step_recover2_and_fields_equal_airjax(meshes, extended):
    """The builders' with_fields and recover2 outputs, whole dicts, against
    airjax's step on the same capture (2-bit flips at shard edges)."""
    rng = np.random.default_rng(5)
    block = halo.tuned_block(4096)
    n = block * 8
    frames = [synth.make_df17(0x400000 + i, synth.make_id_me(f"RTWO{i:03d}")) for i in range(12)]
    offsets = sorted({300 * int(o) for o in rng.choice(n // 300 - 1, 10, replace=False)}
                     | {block - 100, 5 * block - 120})
    sent = [frames[i % 12] if i % 3 else synth.flip_bit(synth.flip_bit(frames[i % 12], 20 + i), 60 + i)
            for i in range(len(offsets))]
    iq = synth.modulate(sent, offsets, n, seed=9)
    jbuild = jhalo.build_sharded_decoder_extended_compact if extended else jhalo.build_sharded_decoder_compact
    tbuild = halo.build_sharded_decoder_extended_compact if extended else halo.build_sharded_decoder_compact
    want = jax.device_get(jbuild(meshes[0], n, 64, 128, with_fields=True, recover2=True)(jnp.asarray(iq)))
    got = pipeline.to_host(tbuild(meshes[1], n, 64, 128, with_fields=True, recover2=True)(iq))
    for key in ("fields", "short_fields") if extended else ("fields",):
        assert_same_dict(want.pop(key), got.pop(key))
    assert_same_dict(want, got)
    assert int(got["recovered2"].sum()) > 0


def _same_with_fields(want: dict, got: dict, extended: bool) -> None:
    """A with_fields dict, its field dicts and the rest, key by key."""
    want, got = dict(want), dict(got)
    for key in ("fields", "short_fields") if extended else ("fields",):
        assert_same_dict(want.pop(key), got.pop(key))
    assert_same_dict(want, got)


@pytest.mark.parametrize("recover2", [False, True])
@pytest.mark.parametrize("extended", [False, True])
def test_compact_step_fields_overflow_and_zero_rows_equal_airjax(meshes, extended, recover2):
    """The with_fields steps, whole dicts, against airjax's on every
    format: C below the total (the step overflows; the fields of its C
    rows), that C regrown 4x as the callers regrow it, and C above the
    total (the zero rows hold the fields of an all-zero frame)."""
    rng = np.random.default_rng(21)
    block = halo.tuned_block(4096)
    n = block * 8
    kinds = [synth.make_df17(0x400000 + i, synth.make_id_me(f"FLD{i:05d}")) for i in range(4)] + [
        DF11, DF4, DF5, POS_FRAME]
    offsets = sorted({300 * int(o) for o in rng.choice(n // 300 - 1, 14, replace=False)} | {block - 100})
    sent = [kinds[i % len(kinds)] for i in range(len(offsets))]
    sent = [synth.flip_bit(synth.flip_bit(f, 30), 70) if len(f) == 14 and i % 3 == 0 else f
            for i, f in enumerate(sent)]
    iq = synth.modulate(sent, offsets, n, seed=23)
    jbuild = jhalo.build_sharded_decoder_extended_compact if extended else jhalo.build_sharded_decoder_compact
    tbuild = halo.build_sharded_decoder_extended_compact if extended else halo.build_sharded_decoder_compact
    count_key = "n_candidates" if extended else "n_good"
    total = int(tbuild(meshes[1], n, 64, 8 * 64, recover2=recover2)(iq)[count_key])
    assert total >= 4
    overflowed = []
    for c in (total // 2, 4 * (total // 2), total + 20):
        want = jax.device_get(jbuild(meshes[0], n, 64, c, with_fields=True, recover2=recover2)(jnp.asarray(iq)))
        got = pipeline.to_host(tbuild(meshes[1], n, 64, c, with_fields=True, recover2=recover2)(iq))
        _same_with_fields(want, got, extended)
        overflowed.append(bool(got["overflow"]))
    assert overflowed == [True, False, False]


@pytest.mark.parametrize("extended", [False, True])
def test_dense_step_equals_airjax(meshes, extended):
    iq, _ = _capture(8, 1000)
    jbuild = jhalo.build_sharded_decoder_extended if extended else jhalo.build_sharded_decoder
    tbuild = halo.build_sharded_decoder_extended if extended else halo.build_sharded_decoder
    want = jax.device_get(jbuild(meshes[0], len(iq), 16)(jnp.asarray(iq)))
    assert_same_dict(want, pipeline.to_host(tbuild(meshes[1], len(iq), 16)(iq)))


def test_unpack_extended_compact_equals_airjax():
    rng = np.random.default_rng(1)
    out = {"offsets": rng.integers(0, 1 << 20, 9).astype(np.int32), "classmask": rng.integers(0, 64, 9, np.uint8),
           "df": rng.integers(0, 25, 9).astype(np.int32), "icao_ap_short": rng.integers(0, 1 << 24, 9).astype(np.int32),
           "icao_ap_long": rng.integers(0, 1 << 24, 9).astype(np.int32),
           "frames": rng.integers(0, 256, (9, 14), np.uint8), "frames_raw": rng.integers(0, 256, (9, 14), np.uint8),
           "n_candidates": np.int32(7)}
    assert_same_dict(jhalo.unpack_extended_compact(out), halo.unpack_extended_compact(out))
    out["recovered2"] = rng.random(9) < 0.5
    assert_same_dict(jhalo.unpack_extended_compact(out, 5), halo.unpack_extended_compact(out, 5))
    assert halo.EXT_COMPACT_ROW_KEYS == jhalo.EXT_COMPACT_ROW_KEYS
    assert (halo._EXT_MASK_KEYS, halo._EXT_DATA_KEYS, halo._EXT_FRAME_KEYS) == (
        jhalo._EXT_MASK_KEYS, jhalo._EXT_DATA_KEYS, jhalo._EXT_FRAME_KEYS)


def test_builders_raise_as_airjax(meshes):
    for n in (32001, 8 * 238):
        for build in (halo.build_sharded_decoder, halo.build_sharded_decoder_extended):
            with pytest.raises(ValueError) as got:
                build(meshes[1], n, 16)
            with pytest.raises(ValueError) as want:
                {halo.build_sharded_decoder: jhalo.build_sharded_decoder,
                 halo.build_sharded_decoder_extended: jhalo.build_sharded_decoder_extended}[build](meshes[0], n, 16)
            assert str(got.value) == str(want.value)


def test_mesh():
    m = make_mesh(8, "cpu")
    assert m.size == 8 and m.shape == {"t": 8} and m.axis_names == ("t",) and set(m.devices) == {torch.device("cpu")}
    assert make_mesh(device="cpu").size == 1 and make_mesh(3, "cpu", axis="c").shape == {"c": 3}
    assert Mesh(["cpu", torch.device("cpu")]) == make_mesh(2, "cpu")
    with pytest.raises(ValueError):
        Mesh([])
    with pytest.raises(KeyError):
        m.shape["c"]


def test_make_mesh_raises_past_the_cards():
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(ValueError, match=f"requested {have + 1} devices, have {have}"):
        make_mesh(have + 1)
    with pytest.raises(ValueError):
        make_mesh(1, "meta")


def test_to_device_rebuilds_the_views():
    """A shard's dict moved to the first device: one copy per buffer its
    views share (the block-decode kernel's int32 and byte buffers), every
    view rebuilt at its place in the copy; a dict already there is kept."""
    ints, byts = torch.arange(9, dtype=torch.int32), torch.arange(30, dtype=torch.uint8)
    out = {"offsets": ints[:4], "n_detections": ints[-1], "frames": byts[:28].view(2, 14),
           "valid": byts[28:30].view(torch.bool)}
    copies = []

    def copy(flat, device):
        copies.append(flat.numel())
        return flat.clone()

    assert halo._to_device(out, torch.device("cpu"), copy) is out and not copies
    moved = halo._to_device(out, torch.device("cpu", 0), copy)  # another device, as far as the dict can tell
    assert sorted(copies) == [30, 36]
    for key, t in out.items():
        assert torch.equal(moved[key], t) and moved[key].dtype == t.dtype and moved[key].data_ptr() != t.data_ptr()
    assert moved["n_detections"].data_ptr() - moved["offsets"].data_ptr() == 32
    assert moved["valid"].data_ptr() - moved["frames"].data_ptr() == 28


# ---- the shard gather against airjax's composition -------------------------


def _random_shards(d: int, k: int, block: int, seed: int, extended: bool) -> list[dict]:
    """D shards' block-decode outputs: sorted in-block offsets, random
    valid and class bits, random payloads (numpy)."""
    rng = np.random.default_rng(seed)
    shards = []
    for _ in range(d):
        valid = rng.random(k) < 0.8
        s = {"offsets": np.where(valid, np.sort(rng.integers(0, block, k)), 0).astype(np.int32), "valid": valid,
             "frames": rng.integers(0, 256, (k, 14), np.uint8),
             "n_detections": np.int32(rng.integers(0, 2 * k)), "overflow": np.bool_(rng.random() < 0.2),
             "recovered2": rng.random(k) < 0.3}
        if extended:
            s.update({key: rng.random(k) < 0.25 for key in sg.MASK_KEYS})
            s.update(frames_raw=rng.integers(0, 256, (k, 14), np.uint8), df=rng.integers(0, 25, k).astype(np.int32),
                     icao_ap_short=rng.integers(0, 1 << 24, k).astype(np.int32),
                     icao_ap_long=rng.integers(0, 1 << 24, k).astype(np.int32))
        else:
            s.update(good=valid & (rng.random(k) < 0.6), recovered=rng.random(k) < 0.3)
        shards.append(s)
    return shards


def _airjax_gather(shards: list[dict], block: int, max_offset: int, c: int, extended: bool, recover2: bool) -> dict:
    """airjax's compact step (halo.py:369-399, :553-594, :416, :612) after
    the block decode, in a shard_map over len(shards) devices."""
    d, k = len(shards), len(shards[0]["offsets"])
    mesh = jmake_mesh(d)
    stacked = {key: np.stack([s[key] for s in shards]) for key in shards[0]}

    def local(x):
        res = {key: v[0] for key, v in x.items()}
        global_offsets = res["offsets"] + jax.lax.axis_index("t").astype(jnp.int32) * block
        in_range = res["valid"] & (global_offsets <= max_offset)
        if extended:
            classmask = jnp.zeros(k, jnp.int32)
            for i, key in enumerate(jhalo._EXT_MASK_KEYS):
                classmask = classmask | ((res[key] & in_range).astype(jnp.int32) << i)
            mask = classmask > 0
        else:
            mask = res["good"] & res["valid"] & (global_offsets <= max_offset)
        sel, valid_out, count = jhalo._compact_local(mask, k)
        base, total = jhalo._global_base(count, d, "t")

        def scat(v):
            return jhalo._scatter_to_global(v.astype(jnp.int32), valid_out, base, c, "t")

        out = {"offsets": scat(global_offsets[sel]), "frames": scat(res["frames"][sel]).astype(jnp.uint8),
               "n_detections": jax.lax.psum(res["n_detections"], "t"),
               "overflow": jax.lax.psum(res["overflow"].astype(jnp.int32), "t") > 0}
        if extended:
            out.update(classmask=scat(classmask[sel]).astype(jnp.uint8), df=scat(res["df"][sel]),
                       icao_ap_short=scat(res["icao_ap_short"][sel]), icao_ap_long=scat(res["icao_ap_long"][sel]),
                       frames_raw=scat(res["frames_raw"][sel]).astype(jnp.uint8), n_candidates=total)
        else:
            out.update(recovered=scat(res["recovered"][sel]).astype(bool), n_good=total)
        if recover2:
            out["recovered2"] = scat((res["recovered2"] & in_range)[sel]).astype(bool)
        return out

    specs = {key: PartitionSpec("t") for key in stacked}
    fn = jax.shard_map(local, mesh=mesh, in_specs=(specs,), out_specs=PartitionSpec())
    out = jax.device_get(jax.jit(fn)(stacked))
    out["overflow"] = out["overflow"] | (out["n_candidates" if extended else "n_good"] > c)
    return out


@pytest.mark.parametrize("d", [1, 3, 8])
@pytest.mark.parametrize("extended", [False, True])
@pytest.mark.parametrize("recover2", [False, True])
def test_shard_gather_plain_equals_airjax_composition(d, extended, recover2):
    k, block = 40, 600
    max_offset = d * block - 240 - 37  # cuts the last shard's tail, as a capture's end does
    shards = _random_shards(d, k, block, seed=d * 4 + 2 * extended + recover2, extended=extended)
    count_key = "n_candidates" if extended else "n_good"
    totals = []
    for c in (5, 3 * k, d * k + 7):  # C below, near and above the total
        want = _airjax_gather(shards, block, max_offset, c, extended, recover2)
        tshards = [{key: torch.as_tensor(v) for key, v in s.items()} for s in shards]
        got = sg.shard_gather(tshards, block, max_offset, c, extended=extended, recover2=recover2)
        assert_same_dict(want, got)
        totals.append((int(got[count_key]), c))
    assert totals[0][0] > totals[0][1] and totals[-1][0] < totals[-1][1]


@pytest.mark.parametrize("first_shard", [1, 3])
@pytest.mark.parametrize("extended", [False, True])
def test_shard_gather_plain_first_shard_equals_airjax_composition(first_shard, extended):
    """A process's gather in a multi-process decode: its shards from global
    index first_shard on equal airjax's composition over the whole mesh
    with the shards before them empty (no slot valid, no detection)."""
    d, k, block = 3, 40, 600
    n_dev = first_shard + d
    max_offset = n_dev * block - 240 - 37
    shards = _random_shards(d, k, block, seed=first_shard * 2 + extended, extended=extended)
    empty = {key: np.zeros_like(v) for key, v in shards[0].items()}
    for c in (5, d * k + 7):
        want = _airjax_gather([empty] * first_shard + shards, block, max_offset, c, extended, True)
        tshards = [{key: torch.as_tensor(v) for key, v in s.items()} for s in shards]
        got = sg.shard_gather(tshards, block, max_offset, c, extended=extended, recover2=True, first_shard=first_shard)
        assert_same_dict(want, got)
        assert int(got["offsets"][0]) >= first_shard * block
    with pytest.raises(ValueError, match="first shard"):
        sg.shard_gather(tshards, block, max_offset, 8, extended=extended, recover2=True, first_shard=-1)


@pytest.mark.parametrize("first_shard", [0, 2])
@pytest.mark.parametrize("extended", [False, True])
@pytest.mark.parametrize("recover2", [False, True])
def test_shard_gather_plain_with_fields_equals_airjax_composition(first_shard, extended, recover2):
    """shard_gather_plain(with_fields=True): airjax's composition then
    extract_fields (and, extended, extract_short_fields_from_raw) over the
    whole C-row buffer, zero rows included, for C below and above the
    total, and as a process's shards from global index first_shard."""
    from airjax.protocol.fields import extract_fields
    from airjax.protocol.shortframe import extract_short_fields_from_raw

    d, k, block = 3, 40, 600
    max_offset = (first_shard + d) * block - 240 - 37
    shards = _random_shards(d, k, block, seed=7 + first_shard + 2 * extended + recover2, extended=extended)
    empty = {key: np.zeros_like(v) for key, v in shards[0].items()}
    tshards = [{key: torch.as_tensor(v) for key, v in s.items()} for s in shards]
    for c in (5, d * k + 7):
        want = _airjax_gather([empty] * first_shard + shards, block, max_offset, c, extended, recover2)
        want["fields"] = jax.device_get(extract_fields(jnp.asarray(want["frames"])))
        if extended:
            want["short_fields"] = jax.device_get(extract_short_fields_from_raw(jnp.asarray(want["frames_raw"])))
        got = sg.shard_gather_plain(tshards, block, max_offset, c, extended=extended, recover2=recover2,
                                    first_shard=first_shard, with_fields=True)
        _same_with_fields(want, got, extended)
        assert sg.shard_gather(tshards, block, max_offset, c, extended=extended, recover2=recover2,
                               first_shard=first_shard, with_fields=True).keys() == got.keys()


def test_shard_gather_checks_its_inputs():
    shards = [{key: torch.as_tensor(v) for key, v in s.items()} for s in _random_shards(2, 8, 300, 0, False)]
    with pytest.raises(ValueError, match="no shards"):
        sg.shard_gather([], 300, 100, 8)
    with pytest.raises(ValueError, match="lacks"):
        sg.shard_gather(shards, 300, 100, 8, recover2=False, extended=True)
    shards[1] = {key: (v[:4] if v.dim() else v) for key, v in shards[1].items()}
    with pytest.raises(ValueError, match="capacities differ"):
        sg.shard_gather(shards, 300, 100, 8)
