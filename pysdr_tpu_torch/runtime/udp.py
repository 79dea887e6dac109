"""UDP control/bandmap integration: the `Name:`/`MODE:`/`SPOT:`/`SpotList:`
/`LOG:` message protocol.

Equivalent of the reference `udp_msg_handler` (reference udp.py:30-211) and
its keyer/bandmap UDP clients (watchdog.py:96-136): colon-delimited
newline-terminated text messages toggle SO2V/SPLIT, query the server name
and mode, relay spots, ingest spot lists (`SpotList:<band>:<list>`),
recolor spots on `LOG:CALL:BAND:FREQ:MODE:...`, and answer
RunFreq/SpotFreq suggestions by searching the current spot table for a
quiet/active frequency. Spots feed the pan-adaptor overlay (the reference's
`Plotting.SPOT` TextItems, Plotting.py:634-686).

The port's own copy of pysdr_tpu/runtime/udp.py, with its imports rewritten
to pysdr_tpu_torch: the port imports nothing of the JAX package.
"""

from __future__ import annotations

import ast
import dataclasses
import socket
import threading

SERVER_NAME = "pysdr-tpu"
KEYER_UDP_PORT = 7388     # reference tcp_server lib convention
BANDMAP_UDP_PORT = 7389


@dataclasses.dataclass
class Spot:
    call: str
    freq_khz: float
    color: str = "k"       # reference recolors logged spots 'r'
    mode: str = ""

    def as_tuple(self):
        return (self.call, self.freq_khz, self.color)


class SpotTable:
    """Current bandmap spots (reference P.NEW_SPOT_LIST / addSpot path)."""

    def __init__(self):
        self._spots: list[Spot] = []
        self._lock = threading.Lock()

    def replace(self, spots):
        with self._lock:
            self._spots = list(spots)

    def add(self, spot: Spot):
        with self._lock:
            self._spots = [s for s in self._spots if s.call != spot.call]
            self._spots.append(spot)

    def recolor(self, call: str, color: str):
        with self._lock:
            for s in self._spots:
                if s.call == call:
                    s.color = color

    def all(self) -> list[Spot]:
        with self._lock:
            return list(self._spots)

    def clear(self):
        with self._lock:
            self._spots = []

    def find_quiet_freq(self, lo_khz: float, hi_khz: float,
                        min_sep_khz: float = 0.5) -> float:
        """RunFreq suggestion: largest gap between spots in [lo, hi]
        (reference RunFreq search, udp.py:150-211)."""
        with self._lock:
            fs = sorted([s.freq_khz for s in self._spots
                         if lo_khz <= s.freq_khz <= hi_khz])
        edges = [lo_khz] + fs + [hi_khz]
        best_gap, best_f = -1.0, 0.5 * (lo_khz + hi_khz)
        for a, b in zip(edges[:-1], edges[1:]):
            if b - a > best_gap:
                best_gap, best_f = b - a, 0.5 * (a + b)
        return best_f if best_gap >= min_sep_khz else 0.0

    def find_spot_freq(self, not_worked_colors=("k", "b")) -> float:
        """SpotFreq suggestion: next un-worked spot."""
        with self._lock:
            for s in self._spots:
                if s.color in not_worked_colors:
                    return s.freq_khz
        return 0.0


class UdpMsgHandler:
    """Parses and dispatches the reference message protocol. State flags
    mirror P.SO2V / P.DXSPLIT / ENABLE_AUTO_MUTE (udp.py:43-60)."""

    def __init__(self, executive=None, spots: SpotTable | None = None,
                 mode_name: str = "USB", band: str = "20m"):
        self.ex = executive
        self.spots = spots or SpotTable()
        self.so2v = False
        self.dxsplit = False
        self.mode_name = mode_name
        self.band = band
        self.relay = None          # optional callable(msg) to bandmap
        self.on_spots = None       # optional callable(SpotTable) — fired
                                   # after every spot-table change so the
                                   # display overlay stays in sync
                                   # (app._sync_spots)

    @property
    def auto_mute(self) -> bool:
        return self.so2v or self.dxsplit

    def _apply_mute_policy(self, entering: bool):
        """SO2V/SPLIT ON arms strong-signal auto-mute on every RX and
        unmutes RX0; OFF disarms and restores RX0 mute (the reference's
        `P.ENABLE_AUTO_MUTE = DXSPLIT or SO2V; gui.MuteCB(0, not SO2V)`,
        reference udp.py:43-60). Applied at the next block boundary."""
        if self.ex is None:
            return
        self.ex.post("set_auto_mute_all", self.auto_mute)
        self.ex.post("set_mute", 0, not entering)

    def handle(self, msg: str) -> list[str]:
        """Process one datagram (possibly multiple newline-separated
        messages); returns replies to send back."""
        replies = []
        for m in msg.split("\n"):
            m = m.strip()
            if not m:
                continue
            mm = m.split(":")
            key = mm[0]
            if key == "SO2V":
                self.so2v = mm[1] == "ON"
                self._apply_mute_policy(self.so2v)
            elif key == "SPLIT":
                self.dxsplit = mm[1] == "ON"
                self._apply_mute_policy(self.dxsplit)
            elif key == "Name":
                if mm[1] == "?":
                    replies.append(f"Name:{SERVER_NAME}\n")
            elif key == "MODE":
                if mm[1] == "?":
                    replies.append(f"MODE:{self.mode_name}\n")
                else:
                    self.mode_name = mm[1]
                    if self.ex is not None:
                        from pysdr_tpu_torch import tables
                        self.ex.post("set_mode", 0,
                                     tables.mode_from_name(mm[1]))
            elif key == "SPOT":
                if self.relay:
                    self.relay(m)
            elif key == "SpotList":
                if mm[1] == "Refresh":
                    if self.relay:
                        self.relay(f"SpotList:{self.band}:?\n")
                elif mm[1] != "?" and len(mm) > 2:
                    lst = ast.literal_eval(":".join(mm[2:]))
                    self.spots.replace(
                        Spot(call=t[0], freq_khz=float(t[1]),
                             color=t[2] if len(t) > 2 else "k")
                        for t in lst)
                    if self.on_spots:
                        self.on_spots(self.spots)
            elif key == "LOG":
                # LOG:CALL:BAND:FREQ:MODE:DATE_OFF:TIME_OFF (udp.py:115)
                self.spots.recolor(mm[1], "r")
                if self.on_spots:
                    self.on_spots(self.spots)
            elif key == "RunFreq":
                lo, hi = float(mm[1]), float(mm[2])
                replies.append(f"RunFreq:{self.spots.find_quiet_freq(lo, hi):.3f}\n")
            elif key == "SpotFreq":
                replies.append(f"SpotFreq:{self.spots.find_spot_freq():.3f}\n")
        return replies


class UdpServer:
    """Datagram server binding the handler (reference open_udp_client on
    KEYER_UDP_PORT, watchdog.py:96-123)."""

    def __init__(self, handler: UdpMsgHandler, port: int = KEYER_UDP_PORT,
                 host: str = "127.0.0.1"):
        self.handler = handler
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self.sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self.sock.bind((host, port))
        self.port = self.sock.getsockname()[1]
        self._stop = threading.Event()
        self._thread = None

    def start(self):
        def loop():
            self.sock.settimeout(0.5)
            while not self._stop.is_set():
                try:
                    data, addr = self.sock.recvfrom(65536)
                except socket.timeout:
                    continue
                except OSError:
                    return
                try:
                    for r in self.handler.handle(
                            data.decode(errors="replace")):
                        self.sock.sendto(r.encode(), addr)
                except Exception:  # noqa: BLE001 — one malformed
                    # datagram must not kill the bandmap/keyer thread
                    import sys
                    import traceback
                    print("udp: bad datagram "
                          f"{data[:80]!r}: {traceback.format_exc(limit=1)}",
                          file=sys.stderr, flush=True)
        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        self.sock.close()
