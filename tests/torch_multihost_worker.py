"""One rank of a multi-process decode of airjax_torch, for
tests/test_torch_multihost.py::test_processes_equal_airjax:

  python tests/torch_multihost_worker.py RANK WORLD PORT SHARDS

joins a gloo group of WORLD processes at tcp://127.0.0.1:PORT with a mesh
of SHARDS CPU shards, makes the same captures as every other rank
(`captures`, from fixed seeds), decodes its own span of each through
airjax_torch.parallel.multihost (the DF17 decode with both gathers and with
a regrow, the extended decode with both gathers, the batched tracker) and
prints one line `RESULT <json>` (`results`). It refuses to import jax or
airjax, as the port must run without them.
"""

from __future__ import annotations

import json
import sys

N = 32768  # 8 global shards of 4096 samples: 2 ranks x 4 shards or 4 x 2
ICAO = 0x7C6B30
AP_ICAO = 0x40621D


class _Refuse:
    """Refuses any import of jax, jaxlib or airjax."""

    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "airjax"):
            raise ImportError(f"refused here: {name}")
        return None


def captures(synth, shortframe) -> dict:
    """The global captures, from either package's synth and shortframe
    (byte-identical): name -> (iq, offsets). Frames straddle the shard
    edges and every rank boundary of 2 and 4 ranks, one ends at the
    capture's end and one carries a 1-bit error."""
    ident = synth.make_df17(ICAO, synth.make_id_me("MHTORCH"))
    pos = synth.make_df17(ICAO, synth.make_position_me(tc=11, altitude_ft=5000, cpr_lat=93000, cpr_lon=51372,
                                                       odd=False))
    df17_offsets = [1000, 4096 - 100, 8192 - 120, 12000, 16384 - 120, 24576 - 120, N - 240]
    df17_frames = [ident, pos, ident, synth.flip_bit(pos, 40), ident, pos, ident]
    ext_frames = [ident, shortframe.make_df11(AP_ICAO), shortframe.make_df4(AP_ICAO, 9000), pos,
                  shortframe.make_df11(AP_ICAO, capability=5), shortframe.make_df5(AP_ICAO, squawk=7421),
                  synth.make_df17(AP_ICAO, synth.make_id_me("APCALL"))]
    ext_offsets = [2000, 8192 - 60, 9000, 16384 - 120, 24576 - 60, 28000, 30000]
    return {"df17": (synth.modulate(df17_frames, df17_offsets, N, seed=9), df17_offsets),
            "extended": (synth.modulate(ext_frames, ext_offsets, N, seed=10), ext_offsets)}


def hits_json(hits) -> list:
    return [[h[1], h[2].hex(), h[3]] for h in hits]


def packets_json(packets) -> list:
    return [[off, repr(p)] for off, p in packets]


def tracker_json(aircrafts: dict, aircraft_to_json) -> dict:
    """The tracker's state as its checkpoint writes it; a time still at its
    wall-clock default is not compared (the decodes stamp 100.0)."""
    out = {}
    for icao, a in sorted(aircrafts.items()):
        d = aircraft_to_json(a)
        out[f"{icao:06x}"] = {k: None if isinstance(v, float) and v >= 1e9 else v for k, v in d.items()}
    return out


def results(multihost, tracker_cls, aircraft_to_json, local: dict, mesh=None) -> dict:
    """The decodes of one rank's spans (`local`: name -> span) -> JSON-able
    results; with airjax's multihost and mesh=None, airjax's of the whole
    capture."""
    kw = {} if mesh is None else {"mesh": mesh}
    out = {}
    for gather in ("compact", "dense"):
        hits, stats = multihost.decode_capture(local["df17"], gather=gather, **kw)
        out[f"df17_{gather}"] = [hits_json(hits), stats]
        packets, stats = multihost.decode_capture_extended(local["extended"], now=100.0, gather=gather, **kw)
        out[f"extended_{gather}"] = [packets_json(packets), stats]
    hits, stats = multihost.decode_capture(local["df17"], capacity_per_shard=1, **kw)
    out["df17_regrow"] = [hits_json(hits), stats]
    packets, stats = multihost.decode_capture_extended(local["extended"], capacity_per_shard=1, now=100.0, **kw)
    out["extended_regrow"] = [packets_json(packets), stats]
    tracker = tracker_cls()
    applied, stats = multihost.decode_capture_extended_batched(local["extended"], tracker, now=100.0, **kw)
    out["batched"] = [applied, stats, tracker_json(tracker.aircrafts, aircraft_to_json)]
    return out


def main() -> None:
    rank, world, port, shards = map(int, sys.argv[1:5])
    sys.meta_path.insert(0, _Refuse())

    from airjax_torch.io import synth
    from airjax_torch.parallel import multihost
    from airjax_torch.parallel.mesh import make_mesh
    from airjax_torch.protocol import shortframe
    from airjax_torch.track.batch import ExtendedBatchTracker
    from airjax_torch.track.state import aircraft_to_json

    assert multihost.init("gloo", f"tcp://127.0.0.1:{port}", world, rank) == (rank, world)
    span = N // world
    local = {name: iq[rank * span : (rank + 1) * span] for name, (iq, _) in captures(synth, shortframe).items()}
    out = results(multihost, ExtendedBatchTracker, aircraft_to_json, local, mesh=make_mesh(shards, device="cpu"))
    assert not [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "airjax")]
    print("RESULT " + json.dumps({"rank": rank, **out}), flush=True)
    multihost.dist.destroy_process_group()


if __name__ == "__main__":
    main()
