"""airjax_torch's user surfaces on the CPU: the curses TUI through a real
pty (a fresh interpreter, as tests/test_tui_pty.py drives airjax's), the
web display's HTTP endpoints, static files (the port's own copy) and
WebSocket handshake and broadcast (as tests/test_web.py), its batched
sink against airjax's, and the CLI's tracker flags and their messages
against airjax's CLI."""

import base64
import contextlib
import io
import json
import os
import pathlib
import pty
import select
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from airjax import cli as jcli
from airjax.ui import web as jweb
from airjax_torch import cli as tcli
from airjax_torch import runner as trunner
from airjax_torch.io import synth
from airjax_torch.io.c16 import save_c16
from airjax_torch.protocol.packet import AdsbPacket
from airjax_torch.ui import tui as ttui
from airjax_torch.ui import web as tweb

REPO = pathlib.Path(__file__).resolve().parent.parent

_TUI_CHILD = r"""
import os, sys, threading
os.environ["TERM"] = "xterm"
from airjax_torch.io import synth
from airjax_torch.runner import run_stream
from airjax_torch.ui.tui import TuiApp, interactive_display

frames = [synth.make_df17(0x4840D6, synth.make_id_me("TUIVEL")),
          synth.make_df17(0x4840D6, synth.make_velocity_me(ew_kt=-8, ns_kt=-159, vertical_rate_fpm=-832))]
iq = synth.modulate(frames, [500, 1500], 20000, seed=3)
app = TuiApp()
sink = app.batched_sink(extended=True) if sys.argv[1] == "batched" else app.on_packet
decode = threading.Thread(target=run_stream, args=(iter([iq]), sink), kwargs={"extended": True, "device": "cpu"},
                          daemon=True)
decode.start()
interactive_display(app)
decode.join()  # the interpreter must not exit inside a torch op
"""


def _drive_pty(argv: list[str], want: list[bytes], env=None) -> tuple[bool, bytes, int, bytes]:
    """Run argv on a pty until every `want` shows, press q; -> (saw, screen, rc, stderr)."""
    parent_fd, child_fd = pty.openpty()
    proc = subprocess.Popen(argv, stdin=child_fd, stdout=child_fd, stderr=subprocess.PIPE, cwd=REPO,
                            env=dict(os.environ, PYTHONPATH=str(REPO), TERM="xterm", **(env or {})),
                            close_fds=True)
    os.close(child_fd)
    deadline = time.time() + 120
    buf, saw = b"", False
    try:
        while time.time() < deadline:
            r, _, _ = select.select([parent_fd], [], [], 1.0)
            if r:
                try:
                    chunk = os.read(parent_fd, 65536)
                except OSError:
                    break
                if not chunk:
                    break
                buf += chunk
            if all(w in buf for w in want):
                saw = True
                break
        os.write(parent_fd, b"q")
        try:
            _, err = proc.communicate(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            _, err = proc.communicate()
    finally:
        os.close(parent_fd)
    return saw, buf, proc.returncode, err or b""


@pytest.mark.parametrize("sink", ["packets", "batched"])
def test_tui_renders_the_velocity_column(sink):
    saw, buf, rc, err = _drive_pty([sys.executable, "-c", _TUI_CHILD, sink], [b"159 kt", b"TUIVEL"])
    assert saw, (buf[-2000:], err[-2000:])
    assert rc == 0, err[-2000:]


def test_cli_interactive_batched_saves_state(tmp_path):
    """`adsb -m interactive --batched --recover2 --state FILE` on the CPU:
    the table fills, q quits, the checkpoint is written (and airjax reads it)."""
    path = tmp_path / "state.json"
    argv = [sys.executable, "-m", "airjax_torch.cli", "adsb", "--synthetic", "2", "-m", "interactive", "--batched",
            "--recover2", "--state", str(path), "--torch-device", "cpu"]
    saw, buf, rc, err = _drive_pty(argv, [b"SYN100", b"airjax adsb tracker"])
    assert saw, (buf[-2000:], err[-2000:])
    assert rc == 0, err[-2000:]
    from airjax.track.state import load_state

    assert len(load_state(path)) >= 1


def test_tui_rows_equal_airjax():
    from airjax.protocol.packet import AdsbPacket as JPacket
    from airjax.ui.tui import TuiApp as JTui

    frames = [synth.make_df17(0x4840D6, synth.make_id_me("ROWS")),
              synth.make_df17(0x4840D6, synth.make_velocity_me(30, 40)),
              synth.make_df17(0x123456, synth.make_position_me(11, 9000, 93000, 51372, False))]
    t_app, j_app = ttui.TuiApp(evict_after_s=3600.0), JTui(evict_after_s=3600.0)
    now = time.time()
    for f in frames:
        t_app.on_packet(AdsbPacket.from_bytes(f, now))
        j_app.on_packet(JPacket.from_bytes(f, now))
    t_app._drain(), j_app._drain()
    assert list(t_app._rows()) == list(j_app._rows()) and t_app.num_packets == 3
    assert ttui.HEADER == ["ICAO", "Callsign", "Altitude", "Latitude", "Longitude", "Velocity", "Age"]


@pytest.fixture(scope="module")
def display():
    d = tweb.WebDisplay(port=0, quiet=True, extended_schema=True)
    threading.Thread(target=d.serve_forever, daemon=True).start()
    for _ in range(100):
        if d._httpd is not None:
            break
        time.sleep(0.05)
    assert d._httpd is not None
    d.port = d._httpd.server_address[1]
    yield d
    d.shutdown()


def _get(display, path):
    return urllib.request.urlopen(f"http://127.0.0.1:{display.port}{path}", timeout=5)


def _ws_connect(port: int) -> tuple[socket.socket, str]:
    s = socket.create_connection(("127.0.0.1", port), timeout=5)
    key = base64.b64encode(b"0123456789abcdef").decode()
    s.sendall((f"GET /ws HTTP/1.1\r\nHost: x\r\nUpgrade: websocket\r\nConnection: Upgrade\r\n"
               f"Sec-WebSocket-Key: {key}\r\nSec-WebSocket-Version: 13\r\n\r\n").encode())
    time.sleep(0.2)
    return s, s.recv(2048).decode(errors="replace")


def _ws_frames(s: socket.socket, n: int, timeout: float = 5.0) -> list[dict]:
    s.settimeout(0.3)
    data, out = b"", []
    deadline = time.time() + timeout
    while time.time() < deadline and len(out) < n:
        try:
            data += s.recv(65536)
        except socket.timeout:
            continue
        while len(data) >= 2:
            ln, off = data[1] & 0x7F, 2
            if ln == 126:
                ln, off = int.from_bytes(data[2:4], "big"), 4
            if len(data) < off + ln:
                break
            out.append(json.loads(data[off : off + ln]))
            data = data[off + ln :]
    return out


def test_web_endpoints_and_static_files(display):
    assert json.load(_get(display, "/api/data")) == {"id": 123, "message": "Hello from airjax backend!"}
    static = REPO / "airjax_torch" / "ui" / "static"
    assert tweb._STATIC_DIR.resolve() == static.resolve()
    assert _get(display, "/").read() == (static / "index.html").read_bytes()
    for name in ("app.js", "applogic.js", "projection.js", "airfields.csv"):
        assert _get(display, f"/{name}").read() == (static / name).read_bytes()
    with pytest.raises(urllib.error.HTTPError) as e:
        _get(display, "/../../etc/passwd")
    assert e.value.code == 404


def test_web_websocket_handshake_broadcast_and_snapshot(display):
    s, resp = _ws_connect(display.port)
    assert "101" in resp.splitlines()[0]
    assert "Sec-WebSocket-Accept: BACScCJPNqyz+UBoqMH89VmURoA=" in resp  # RFC 6455 known answer
    display.on_packet(AdsbPacket.from_hex("8d7c6b3020293532d70820fc8090"))
    (summary,) = [f for f in _ws_frames(s, 1) if f["icao"] == 0x7C6B30][:1]
    assert summary["callsign"] == "JST250__" and "groundSpeedKt" in summary
    s.close()
    snap = json.load(_get(display, "/api/aircraft"))
    assert any(a["icao"] == 0x7C6B30 for a in snap)


@pytest.mark.parametrize("extended", [False, True])
def test_web_batched_sink_equals_airjax(extended):
    """The batched sink through run_stream: the same snapshot and the same
    coalesced broadcasts (one per touched aircraft per block) as airjax's."""
    from airjax.runner import run_stream as j_run_stream

    frames = [synth.make_df17(0x7C6B30, synth.make_id_me("WEBBAT")),
              synth.make_df17(0x7C6B30, synth.make_position_me(11, 2600, 93000, 51372, False)),
              synth.make_df17(0x7C6B30, synth.make_position_me(11, 2650, 74158, 50194, True)),
              synth.make_df17(0x40621D, synth.make_velocity_me(55, -10, 640))]
    iq = synth.modulate(frames, [500, 4500, 9000, 14000], 40000, seed=5)
    blocks = [iq[:20000], iq[20000:]]
    displays = []
    for cls, run in ((tweb.WebDisplay, lambda s: trunner.run_stream(iter(blocks), s, extended=extended,
                                                                    device="cpu")),
                     (jweb.WebDisplay, lambda s: j_run_stream(iter(blocks), s, extended=extended))):
        d = cls(port=0, quiet=True, extended_schema=extended)
        cid, q = d.broadcast.subscribe()
        run(d.batched_sink(extended=extended))
        msgs = []
        while not q.empty():
            msgs.append(json.loads(q.get_nowait()))
        displays.append((d.snapshot(), msgs))
    (snap_t, msgs_t), (snap_j, msgs_j) = displays
    for x in snap_t + snap_j + msgs_t + msgs_j:
        x.pop("lastContact")
    assert snap_t == snap_j and msgs_t == msgs_j and len(snap_t) == 2


def _run_cli(main, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        try:
            rc = main(argv)
        except SystemExit as e:
            rc = e.code
    return rc, out.getvalue(), err.getvalue()


@pytest.mark.parametrize("argv,rc", [
    (["adsb", "--synthetic", "1", "--ref-lat", "52.3"], 2),
    (["adsb", "--synthetic", "1", "--ref-lon", "4.7"], 2),
    (["adsb", "--synthetic", "1", "--batched"], 0),
    (["adsb", "--synthetic", "1", "--state", "never-written.json"], 0),
    (["adsb", "--synthetic", "1", "-m", "bogus"], 2),
])
def test_cli_checks_and_messages_equal_airjax(argv, rc, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    got = _run_cli(tcli.main, argv + ["--torch-device", "cpu"])
    want = _run_cli(jcli.main, argv)
    assert got[0] == want[0] == rc
    assert got[2].replace("airjax_torch", "airjax").splitlines()[-1:] == want[2].splitlines()[-1:]
    assert not os.path.exists("never-written.json")


def test_cli_bad_state_file(tmp_path):
    bad = tmp_path / "bad.json"
    bad.write_text("{not json")
    for main, extra in ((tcli.main, ["--torch-device", "cpu"]), (jcli.main, [])):
        rc, _, err = _run_cli(main, ["adsb", "--synthetic", "1", "-m", "interactive", "--state", str(bad)] + extra)
        assert rc == 1 and f"error: bad state file {bad}" in err


@pytest.mark.parametrize("recover2", [False, True])
@pytest.mark.parametrize("extended", [False, True])
def test_cli_stream_recover2_stats_equal_airjax(extended, recover2):
    argv = ["adsb", "--synthetic", "2"] + ["--extended"] * extended + ["--recover2"] * recover2
    rc_t, out_t, _ = _run_cli(tcli.main, argv + ["--torch-device", "cpu"])
    rc_j, out_j, _ = _run_cli(jcli.main, argv)
    assert rc_t == rc_j == 0

    def stats(text):
        line = [ln for ln in text.splitlines() if ln.startswith("stats: ")][-1]
        return line[: line.index(", 'msamples_per_s'")]

    assert stats(out_t) == stats(out_j) and "'recovered2': 0" in stats(out_t)


def test_cli_web_mode_serves_then_saves_state(tmp_path, monkeypatch):
    """`adsb -m web --batched --state FILE`: the decode runs, the server
    answers, Ctrl-C (a KeyboardInterrupt from the wait loop) saves the
    table; a second run restores it."""
    path = tmp_path / "web.json"
    seen = {}

    def interrupt(_):
        raise KeyboardInterrupt

    monkeypatch.setattr(tcli.time, "sleep", interrupt)
    real_start = tweb.WebDisplay.start_background

    def start(self):
        self.port = 0  # a free port
        t = real_start(self)
        for _ in range(100):
            if self._httpd is not None:
                break
            t.join(0.05)  # time.sleep is the patched one
        seen["display"] = self
        return t

    monkeypatch.setattr(tweb.WebDisplay, "start_background", start)
    for _ in range(2):
        rc, out, _ = _run_cli(tcli.main, ["adsb", "--synthetic", "2", "-m", "web", "--batched", "--state", str(path),
                                          "--torch-device", "cpu"])
        assert rc == 0 and "source exhausted; web server still running" in out
        d = seen["display"]
        snap = json.load(urllib.request.urlopen(f"http://127.0.0.1:{d._httpd.server_address[1]}/api/aircraft",
                                                timeout=5))
        d.shutdown()
        assert {a["callsign"] for a in snap} >= {"SYN100__"}
    assert "restored" in out and f"saved {len(snap)} aircraft to {path}" in out
