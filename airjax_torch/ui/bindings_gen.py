"""TS bindings generator — the ts-rs analogue (airjax/ui/bindings_gen.py).

The reference derives bindings/AircraftSummary.ts from its Rust structs
via ts-rs (the reference's src/adsb/aircraft.rs:16, cpr.rs:12-16), so
backend types and the frontend contract cannot drift. The port's wire
schema lives in AircraftSummary.to_json (airjax_torch/track/aircraft.py,
the same keys as airjax's); this module is the one declarative description
of that schema, and `render()` emits the checked-in bindings/*.ts from it,
byte for byte the files airjax's generator emits (their header comments
name airjax's classes, whose wire format the port keeps).
tests/test_torch_frontend.py holds generated_files() to the committed
files and schema_keys() to what the port's to_json emits.

Check the committed files with:
    python -m airjax_torch.ui.bindings_gen --check
(without --check it writes them).
"""

from __future__ import annotations

import textwrap
from dataclasses import dataclass, field


@dataclass(frozen=True)
class Field:
    name: str
    ts_type: str
    doc: str | None = None  # rendered as a /** ... */ block when set


@dataclass(frozen=True)
class Interface:
    filename: str
    name: str
    header: str  # leading // comment block, verbatim
    fields: tuple[Field, ...]
    imports: tuple[str, ...] = ()


def render(iface: Interface) -> str:
    lines = [f"// {ln}".rstrip() for ln in iface.header.splitlines()]
    for imp in iface.imports:
        lines.append(imp)
    lines.append("")
    lines.append(f"export interface {iface.name} {{")
    for f in iface.fields:
        if f.doc is not None:
            doc_lines = f.doc.splitlines()
            if len(doc_lines) == 1 and len(doc_lines[0]) <= 70:
                lines.append(f"  /** {doc_lines[0]} */")
            else:
                lines.append("  /**")
                lines.extend(f"   * {ln}".rstrip() for ln in doc_lines)
                lines.append("   */")
        lines.append(f"  {f.name}: {f.ts_type};")
    lines.append("}")
    return "\n".join(lines) + "\n"


GEO_IMPORT = 'import type { GeographicPosition } from "./GeographicPosition";'

# Reference-parity keys (bindings/AircraftSummary.ts mirrors the ts-rs
# output for src/adsb/aircraft.rs:17-23).
_PARITY_FIELDS = (
    Field("icao", "number"),
    Field("callsign", "string"),
    Field("altitude", "number"),
    Field("geoPosition", "GeographicPosition | null"),
    Field("lastContact", "number"),
)

# Extension keys emitted only with --extended (to_json(extended=True)).
_EXTENDED_FIELDS = (
    Field("groundSpeedKt", "number | null"),
    Field("trackDeg", "number | null"),
    Field("verticalRateFpm", "number | null"),
    Field("squawk", "number | null"),
    Field("onGround", "boolean"),
    Field(
        "acasRa",
        "string | null",
        doc="Active TCAS resolution-advisory clauses, comma-joined (DF16 BDS 3,0).",
    ),
    Field(
        "bdsCandidates",
        "string[] | null",
        doc=(
            "Comm-B BDS registers the last DF20/21 MB field validated as\n"
            '(e.g. ["5,0"] or the ambiguous ["5,0", "6,0"]). Length > 1 means the\n'
            "register inference was ambiguous and derived fields are uncertain."
        ),
    ),
    Field(
        "met",
        "{ [key: string]: number } | null",
        doc=(
            "BDS 4,4 meteorological routine report (applied only when the MB\n"
            "validated as exactly this register): wind_speed_kt, wind_dir_deg,\n"
            "static_air_temp_c, avg_static_pressure_hpa, humidity_pct as\n"
            "available."
        ),
    ),
    Field(
        "commdElm",
        "{ hex: string; segments: number; bds: string[]; "
        "decoded?: { [key: string]: number | string } } | null",
        doc=(
            "Comm-D ELM content (DF24 segment reassembly): full payload hex,\n"
            "segment count, BDS register candidates inferred from the first 7\n"
            "bytes (empty = non-register payload), and the decoded register\n"
            "when the inference is unambiguous."
        ),
    ),
)

INTERFACES = (
    Interface(
        filename="GeographicPosition.ts",
        name="GeographicPosition",
        header="Matches airjax.track.cpr.GeographicPosition.to_json().",
        fields=(Field("latitude", "number"), Field("longitude", "number")),
    ),
    Interface(
        filename="AircraftSummary.ts",
        name="AircraftSummary",
        header=(
            "Type contract for the airjax WebSocket/REST payloads. Matches the\n"
            "camelCase JSON emitted by airjax.track.aircraft.AircraftSummary.to_json()\n"
            "(and is wire-compatible with the reference's ts-rs-generated bindings,\n"
            "so either frontend can talk to either backend)."
        ),
        fields=_PARITY_FIELDS,
        imports=(GEO_IMPORT,),
    ),
    Interface(
        filename="AircraftSummaryExtended.ts",
        name="AircraftSummaryExtended",
        header=(
            "Type contract for the EXTENDED WebSocket/REST payloads (backend run\n"
            "with --extended): the reference-parity AircraftSummary plus velocity\n"
            "and identity extensions. Matches\n"
            "airjax.track.aircraft.AircraftSummary.to_json(extended=True)."
        ),
        fields=_PARITY_FIELDS + _EXTENDED_FIELDS,
        imports=(GEO_IMPORT,),
    ),
)


def generated_files() -> dict[str, str]:
    """{filename: rendered text} for every binding."""
    return {i.filename: render(i) for i in INTERFACES}


def schema_keys(extended: bool) -> set[str]:
    """The declared wire keys — must equal to_json's emitted key set."""
    fields = _PARITY_FIELDS + (_EXTENDED_FIELDS if extended else ())
    return {f.name for f in fields}


def main(argv=None) -> int:
    import argparse
    import pathlib
    import sys

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument(
        "--check", action="store_true",
        help="verify the checked-in files match instead of writing",
    )
    args = ap.parse_args(argv)
    bindings = pathlib.Path(__file__).resolve().parents[2] / "bindings"
    rc = 0
    for name, text in generated_files().items():
        path = bindings / name
        if args.check:
            on_disk = path.read_text() if path.exists() else None
            if on_disk != text:
                print(f"STALE: {path}", file=sys.stderr)
                rc = 1
            else:
                print(f"ok: {path}")
        else:
            path.write_text(text)
            print(f"wrote {path}")
    return rc


if __name__ == "__main__":
    import sys

    sys.exit(main())
