"""Rig-control client: attach the SDR to a physical transceiver.

Equivalent of the reference's `rig_io.socket_io.open_rig_connection` socket
object with `.get_freq/.set_freq/.get_mode/.set_mode/.get_vfo/.set_vfo/
.active` (reference pySDR.py:174, gui.py:776-778,1402-1483,
rig_control.py:45-366) — the reference uses it for follow-frequency /
follow-band / clarifier sync between the SDR and a rig (RIG_Updater thread,
pySDR.py:182-205). Here it is a hamlib rigctl-net TCP client (works
against real rigctld or this framework's own HamlibServer), plus the
follow-loop that keeps a bank channel tracking the rig.

The port's own copy of pysdr_tpu/runtime/rig.py, with its imports rewritten
to pysdr_tpu_torch: the port imports nothing of the JAX package.
"""

from __future__ import annotations

import socket
import threading
import time


class RigConnection:
    """hamlib rigctl-net protocol client."""

    def __init__(self, host: str = "127.0.0.1", port: int = 4532,
                 timeout: float = 2.0):
        self.host, self.port, self.timeout = host, port, timeout
        self._sock: socket.socket | None = None
        self._lock = threading.Lock()
        self.connection = "HAMLIB"
        self.rig_type2 = "hamlib"
        try:
            self._sock = socket.create_connection((host, port),
                                                  timeout=timeout)
            self._sock.settimeout(timeout)
            self.active = True
        except OSError:
            self.active = False

    def _cmd(self, line: str, n_lines: int = 1) -> list[str]:
        if not self.active or self._sock is None:
            return []
        with self._lock:
            try:
                self._sock.sendall((line + "\n").encode())
                buf = b""
                while buf.count(b"\n") < n_lines:
                    # an error reply is a single 'RPRT -n' line even for
                    # multi-line queries: waiting for more would time
                    # out and (worse) mark the connection dead over one
                    # unsupported command
                    if buf.startswith(b"RPRT") and buf.endswith(b"\n"):
                        break
                    chunk = self._sock.recv(4096)
                    if not chunk:
                        self.active = False
                        return []
                    buf += chunk
                return buf.decode(errors="replace").splitlines()
            except socket.timeout:
                # transient stall: drop this reply, keep the connection
                return []
            except OSError:
                self.active = False
                return []

    # --- reference sock API surface (gui.py:1410-1483) ---

    def get_freq(self) -> float:
        r = self._cmd("f")
        try:
            return float(r[0])
        except (IndexError, ValueError):
            return 0.0

    def set_freq(self, freq_hz: float, vfo: str = "A"):
        self._cmd(f"F {freq_hz:.0f}")

    def get_mode(self) -> str:
        r = self._cmd("m", n_lines=2)
        return r[0] if r else ""

    def set_mode(self, mode: str, bw_hz: float = 0):
        self._cmd(f"M {mode} {int(bw_hz) if bw_hz else 0}")

    def get_vfo(self) -> str:
        r = self._cmd("v")
        return (r[0] if r else "VFOA").replace("VFO", "")

    def set_vfo(self, vfo: str):
        self._cmd(f"V VFO{vfo}")

    def read_clarifier(self) -> float:
        """RIT offset in Hz (rigctl 'j' / get_rit; the reference's
        read_clarifier, gui.py:1402-1483)."""
        r = self._cmd("j")
        try:
            return float(r[0])
        except (IndexError, ValueError):
            return 0.0

    def set_clarifier(self, hz: float):
        self._cmd(f"J {hz:.0f}")

    def split(self, on: bool):
        self._cmd(f"S {1 if on else 0} VFOB")

    # --- TX-side ops (reference rig_control.py:268-363: power/mic/
    # monitor sliders, antenna select) via rigctl levels ---

    def _get_level(self, name: str) -> float:
        r = self._cmd(f"l {name}")
        try:
            return float(r[0])
        except (IndexError, ValueError):
            return 0.0

    def _set_level(self, name: str, value: float):
        self._cmd(f"L {name} {value:g}")

    def read_tx_pwr(self) -> float:
        """TX power as a 0..1 fraction (reference read_tx_pwr)."""
        return self._get_level("RFPOWER")

    def set_tx_pwr(self, frac: float):
        self._set_level("RFPOWER", min(max(frac, 0.0), 1.0))

    def read_mic_gain(self) -> float:
        return self._get_level("MICGAIN")

    def set_mic_gain(self, frac: float):
        self._set_level("MICGAIN", min(max(frac, 0.0), 1.0))

    def read_monitor_level(self) -> float:
        return self._get_level("MONITOR_GAIN")

    def set_monitor_level(self, frac: float):
        self._set_level("MONITOR_GAIN", min(max(frac, 0.0), 1.0))

    def get_ant(self) -> int:
        r = self._cmd("y")
        try:
            return int(float(r[0].split()[-1]))
        except (IndexError, ValueError):
            return 0

    def select_ant(self, n: int):
        """Antenna A/B/... select (reference SelectAnt)."""
        self._cmd(f"Y {int(n)}")

    def select_band(self, band: str):
        """Jump to a band's FT8 slot (reference SelectBand sub-band
        jump, rig_control.py:268-300)."""
        from pysdr_tpu_torch.runtime.hopper import BANDS_KHZ
        if band in BANDS_KHZ:
            self.set_freq(BANDS_KHZ[band]["FT8"] * 1e3)

    def close(self):
        if self._sock:
            try:
                self._cmd("q")
                self._sock.close()
            except OSError:
                pass
        self.active = False


class RigFollower:
    """1 Hz rig<->SDR sync loop (reference RIG_Updater, pySDR.py:182-205;
    rig_retune follow-freq/follow-band, gui.py:1402-1483)."""

    def __init__(self, executive, rig: RigConnection, rx_index: int = 0,
                 period_s: float = 1.0, follow_freq: bool = True,
                 follow_band: bool = True, use_clarifier: bool = True):
        self.ex = executive
        self.rig = rig
        self.rx_index = rx_index
        self.period_s = period_s
        self.follow_freq = follow_freq
        self.follow_band = follow_band
        self.use_clarifier = use_clarifier
        self.last_rig_freq = 0.0
        self.last_clarifier_hz = 0.0
        self._stop = threading.Event()
        self._thread = None

    def poll_once(self):
        if not self.rig.active:
            return
        f = self.rig.get_freq()
        if f <= 0:
            return
        # clarifier/RIT sync: the SDR listens where the operator's RIT
        # actually puts the receive frequency (reference rig_retune
        # clarifier handling, gui.py:1402-1483 via read_clarifier)
        if self.use_clarifier:
            try:
                self.last_clarifier_hz = self.rig.read_clarifier()
            except Exception:  # noqa: BLE001 — rig may not support RIT
                self.last_clarifier_hz = 0.0
            f = f + self.last_clarifier_hz
        cur = self.ex.bank._rx_cfgs[self.rx_index].fc_hz
        # min-20-Hz hysteresis like mode_freq_change (receiver.py:653-669)
        if self.follow_freq and abs(f - cur) > 20.0:
            from pysdr_tpu_torch.runtime.hopper import freq2band
            if self.follow_band or freq2band(f) == freq2band(cur):
                self.ex.post("retune", self.rx_index, f)
        self.last_rig_freq = f

    def start(self):
        def loop():
            while not self._stop.is_set():
                self.poll_once()
                self._stop.wait(self.period_s)
        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
