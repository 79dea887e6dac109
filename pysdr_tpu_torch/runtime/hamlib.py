"""Hamlib-protocol TCP server: external apps control each receiver.

Equivalent of the reference's per-RX `HamlibServer(P, port).Run` threads on
ports 4575+i (reference pySDR.py:139-156): wsjtx/fldigi/loggers speak the
hamlib rigctl net protocol (`F <hz>` set freq, `f` get freq, `M <mode>
<bw>` set mode, `m` get mode, `v` VFO, `q` quit, plus the `\\dump_state`
handshake) to tune a receiver. Commands are translated into the bank's
block-boundary control queue (runtime/executive.post), never touching DSP
state directly.

The port's own copy of pysdr_tpu/runtime/hamlib.py, with its imports
rewritten to pysdr_tpu_torch: the port imports nothing of the JAX package.
"""

from __future__ import annotations

import socket
import socketserver
import threading
from collections import deque

from pysdr_tpu_torch import tables

DEFAULT_BASE_PORT = 4575   # reference pySDR.py:139-156

# minimal rigctl dump_state reply (protocol version 0) — enough for wsjtx
DUMP_STATE = "\n".join([
    "0", "2", "2",
    "0.000000 10000000000.000000 0x1ff -1 -1 0x10000003 0x3",
    "0 0 0 0 0 0 0",
    "0 0 0 0 0 0 0",
    "0x1ff 1", "0x1ff 0", "0 0", "0x1e 2400",
    "0x2 500", "0x1 8000", "0x1 2400", "0x20 15000",
    "0x20 8000", "0x40 230000", "0 0", "9990",
    "9990", "10000", "0", "10",
    "10 20 30", "0x3effffff", "0x3effffff", "0x7fffffff",
    "0x7fffffff", "0x7fffffff", "0x7fffffff",
]) + "\n"

MODE_MAP = {
    "USB": tables.Mode.USB, "LSB": tables.Mode.LSB, "AM": tables.Mode.AM,
    "FM": tables.Mode.NFM, "WFM": tables.Mode.WFM, "CW": tables.Mode.CW,
    "CWR": tables.Mode.CW, "RTTY": tables.Mode.RTTY, "PKTUSB": tables.Mode.IQ,
}
# reverse map: FIRST name wins for aliased modes (CW/CWR both map to
# Mode.CW — last-wins reported 'CWR' to clients that set 'CW')
MODE_NAME = {}
for _name, _mode in MODE_MAP.items():
    MODE_NAME.setdefault(_mode, _name)


class RigState:
    """Adapter between the hamlib verbs and one bank channel."""

    def __init__(self, executive, rx_index: int):
        self.ex = executive
        self.i = rx_index
        # TX-side state mirrored for loopback control (reference
        # rig_control.py:268-363 sliders); AF/SQL map onto the bank
        self.levels = {"RFPOWER": 0.5, "MICGAIN": 0.5,
                       "MONITOR_GAIN": 0.0}
        self.ant = 0
        self.rit_hz = 0.0
        # Authoritative dial frequency. Retunes posted via executive.post
        # only land at the next block boundary, so deriving the dial from
        # the bank config between a set_freq/set_rit and its application
        # would combine a stale fc with the new RIT and tune wrong. The
        # dial is therefore updated synchronously here; _known_fc holds
        # every bank fc that is consistent with it (the pre-post value and
        # each posted target), and get_freq resyncs from the bank only
        # when fc moved to a value we never posted (an external retune
        # from the viewer/hopper).
        self.dial_hz: float | None = None
        self._known_fc: set = set()
        # the executive queue can hold SEVERAL retunes mid-block (web
        # pane + wsjtx in the same instant), so the prune below must
        # preserve a window of recent targets, not just the last one
        self._recent_targets: deque = deque(maxlen=8)
        # dial/RIT mutations come from every ThreadingTCPServer client
        # thread (wsjtx polling while the web pane tunes): serialize the
        # read-modify-post sequences so no retune is computed from a
        # dial another thread is mid-update on
        self._lock = threading.Lock()

    @property
    def _cfg(self):
        return self.ex.bank._rx_cfgs[self.i]

    def _get_freq_locked(self) -> float:
        fc = self._cfg.fc_hz
        if self.dial_hz is None or fc not in self._known_fc:
            self.dial_hz = fc - self.rit_hz
            self._known_fc = {fc}
        return self.dial_hz

    def get_freq(self) -> float:
        # displayed (dial) frequency excludes the clarifier shift,
        # like a real rig's RIT
        with self._lock:
            return self._get_freq_locked()

    def _post_retune(self, target_hz: float):
        if len(self._known_fc) > 64:
            # bound the consistency set over long sessions: keep the
            # current fc AND the recent posted targets — any retune
            # still pending in the executive queue at prune time must
            # not be misread as an external retune (which would resync
            # the dial to fc - rit and briefly report a wrong dial to
            # polling clients when RIT is nonzero)
            self._known_fc = {self._cfg.fc_hz, *self._recent_targets}
        self._known_fc.add(self._cfg.fc_hz)
        self._known_fc.add(target_hz)
        self._recent_targets.append(target_hz)
        self.ex.post("retune", self.i, target_hz)

    def set_freq(self, hz: float):
        with self._lock:
            self._get_freq_locked()   # seed _known_fc before mutating
            self.dial_hz = hz
            self._post_retune(hz + self.rit_hz)

    def set_rit(self, hz: float):
        """Clarifier/RIT: shift the RX by hz without moving the dial
        (reference read_clarifier/rig_retune sync, gui.py:1402-1483)."""
        with self._lock:
            dial = self._get_freq_locked()
            self.rit_hz = hz
            self._post_retune(dial + hz)

    def get_mode(self):
        m = self._cfg.mode
        bw = self._cfg.af_bw_hz or tables.MODE_DEFAULT_AF_BW.get(m, 3000)
        return MODE_NAME.get(m, "USB"), int(bw)

    def set_mode(self, name: str, bw: float | None):
        if name.upper() in MODE_MAP:
            self.ex.post("set_mode", self.i, MODE_MAP[name.upper()])
        if bw and bw > 0:
            self.ex.post("set_af_bw", self.i, float(bw))


class _Handler(socketserver.StreamRequestHandler):
    def handle(self):
        rig: RigState = self.server.rig  # type: ignore
        while True:
            line = self.rfile.readline()
            if not line:
                return
            parts = line.decode(errors="replace").strip().split()
            if not parts:
                continue
            cmd, args = parts[0], parts[1:]
            try:
                reply = self._dispatch(rig, cmd, args)
            except Exception:
                reply = "RPRT -1\n"
            if reply is None:
                return
            self.wfile.write(reply.encode())

    def _dispatch(self, rig, cmd, args):
        if cmd in ("q", "Q"):
            return None
        if cmd == "\\dump_state" or cmd == "dump_state":
            return DUMP_STATE
        if cmd == "f" or cmd == "\\get_freq":
            return f"{rig.get_freq():.0f}\n"
        if cmd == "F" or cmd == "\\set_freq":
            rig.set_freq(float(args[0]))
            return "RPRT 0\n"
        if cmd == "m" or cmd == "\\get_mode":
            name, bw = rig.get_mode()
            return f"{name}\n{bw}\n"
        if cmd == "M" or cmd == "\\set_mode":
            bw = float(args[1]) if len(args) > 1 else None
            rig.set_mode(args[0], bw)
            return "RPRT 0\n"
        if cmd == "j" or cmd == "\\get_rit":
            return f"{rig.rit_hz:.0f}\n"
        if cmd == "J" or cmd == "\\set_rit":
            rig.set_rit(float(args[0]))
            return "RPRT 0\n"
        if cmd == "v" or cmd == "\\get_vfo":
            return "VFOA\n"
        if cmd == "V" or cmd == "\\set_vfo":
            return "RPRT 0\n"
        if cmd in ("t", "\\get_ptt"):
            return "0\n"
        if cmd in ("T", "\\set_ptt"):
            return "RPRT 0\n"
        if cmd == "s":
            return "0\nVFOA\n"
        if cmd == "\\chk_vfo":
            return "0\n"
        if cmd in ("l", "\\get_level"):
            name = args[0] if args else ""
            if name == "AF":
                return f"{rig._cfg.af_gain:g}\n"
            if name == "SQL":
                return f"{rig._cfg.squelch_db:g}\n"
            return f"{rig.levels.get(name, 0.0):g}\n"
        if cmd in ("L", "\\set_level"):
            name, val = args[0], float(args[1])
            if name == "AF":
                rig.ex.post("set_af_gain", rig.i, val)
            elif name == "SQL":
                rig.ex.post("set_squelch", rig.i, val)
            else:
                rig.levels[name] = val
            return "RPRT 0\n"
        if cmd in ("y", "\\get_ant"):
            return f"{rig.ant}\n"
        if cmd in ("Y", "\\set_ant"):
            rig.ant = int(float(args[0]))
            return "RPRT 0\n"
        return "RPRT 0\n"


class HamlibServer:
    """One TCP server per receiver (reference spawns one thread per RX)."""

    def __init__(self, executive, rx_index: int, port: int | None = None,
                 host: str = "127.0.0.1"):
        self.port = port if port is not None else DEFAULT_BASE_PORT + rx_index
        self.server = socketserver.ThreadingTCPServer(
            (host, self.port), _Handler, bind_and_activate=False)
        self.server.allow_reuse_address = True
        self.server.daemon_threads = True
        self.server.rig = RigState(executive, rx_index)  # type: ignore
        self.server.server_bind()
        self.server.server_activate()
        self._thread = None

    def start(self):
        self._thread = threading.Thread(target=self.server.serve_forever,
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self.server.shutdown()
        self.server.server_close()


def rigctl_request(port: int, line: str, host="127.0.0.1",
                   timeout=2.0) -> str:
    """Tiny client for tests / scripting (rigctl one-shot)."""
    with socket.create_connection((host, port), timeout=timeout) as s:
        s.sendall((line.strip() + "\n").encode())
        s.settimeout(timeout)
        data = b""
        while not data.endswith(b"\n"):
            chunk = s.recv(4096)
            if not chunk:
                break
            data += chunk
        return data.decode()
