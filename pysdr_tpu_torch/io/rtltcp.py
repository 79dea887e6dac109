"""rtl_tcp network IQ source: live hardware over TCP, no USB required.

The reference reaches real RTL dongles through SoapySDR/librtlsdr USB
bindings (reference BUILD_RTL:37-99, utils.py:71-273 fake driver, SURVEY
§2.8). A TPU host has no USB stack, but every RTL-SDR ships with
`rtl_tcp`, the de-facto network streaming server: 12-byte handshake
(magic "RTL0", tuner type, gain count), then an endless CU8 IQ stream;
the client controls the dongle with 5-byte big-endian commands. This
source speaks that protocol, presenting the same read lifecycle +
Soapy-shaped device surface as the synth/replay sources (io/synth.py),
so `--rtl-tcp host:port` drops straight into the executive and the
viewer's DEV pane drives a real dongle across the network.

Protocol (rtl_tcp.c in librtlsdr): commands
  0x01 set_freq        0x02 set_sample_rate   0x03 set_gain_mode
  0x04 set_gain(0.1dB) 0x05 set_freq_corr(ppm) 0x08 set_agc_mode
  0x09 set_direct_sampling  0x0d set_bias_tee
Samples are unsigned 8-bit I/Q pairs; full scale maps to |x| = 1.0
(the framework's ADC convention, ops/cplx.py).

The port's own copy of pysdr_tpu/io/rtltcp.py, with its imports rewritten to
pysdr_tpu_torch: the port imports nothing of the JAX package.
"""

from __future__ import annotations

import queue
import socket
import struct
import sys
import threading
import time

import numpy as np

MAGIC = b"RTL0"

CMD_SET_FREQ = 0x01
CMD_SET_SAMPLE_RATE = 0x02
CMD_SET_GAIN_MODE = 0x03
CMD_SET_GAIN = 0x04
CMD_SET_FREQ_CORR = 0x05
CMD_SET_AGC_MODE = 0x08
CMD_SET_DIRECT_SAMPLING = 0x09
CMD_SET_BIAS_TEE = 0x0D

TUNER_NAMES = {0: "UNKNOWN", 1: "E4000", 2: "FC0012", 3: "FC0013",
               4: "FC2580", 5: "R820T", 6: "R828D"}

# librtlsdr auto-switches to direct sampling below the tuner range —
# the reference models this on the fake driver (utils direct-sampling
# auto-switch, receiver.py:671-680)
DIRECT_SAMPLING_BELOW_HZ = 24e6

# CU8 -> float32 lookup: (u8 - 127.5) / 127.5, built once. The C++
# converter from the native source layer (native/sdrio.cpp
# psdr_convert_cu8, same convention) is preferred when built.
_CU8_LUT = ((np.arange(256, dtype=np.float32) - 127.5)
            / np.float32(127.5))


def _cu8_to_pairs(raw: np.ndarray) -> np.ndarray:
    """CU8 bytes -> float32 (n, 2) packed pairs (C++ when available)."""
    try:
        from pysdr_tpu_torch.runtime import native
        out = native.convert_cu8(raw)
        if out is not None:
            return out
    except Exception:  # noqa: BLE001 — any native hiccup -> numpy path
        pass
    return _CU8_LUT[raw].reshape(-1, 2)


class RtlTcpSource:
    """Block-pull source over a live rtl_tcp server.

    Same consumer surface as DatReader/SynthSource (`read_data(n)`,
    `read_packed(n)`, `.srate`, `.fc`) plus the Soapy-shaped setters the
    device pane uses (set_gain / set_freq_correction / set_antenna).
    A reader thread drains the socket into a ring so the radio never
    back-pressures the dongle (the reference's async-stream + ring
    pattern, utils.py:98-120).
    """

    def __init__(self, host: str, port: int, fs: float, fc: float,
                 gain_db: float | None = None, ppm: float = 0.0,
                 ring_samples: int = 1 << 22, timeout: float = 5.0,
                 agc: bool = False, bias_tee: bool = False,
                 reconnect: int = 0, reconnect_wait: float = 1.0):
        self.srate = float(fs)
        self.fc = float(fc)
        self._host, self._port = host, port
        self._timeout = timeout
        # auto-reconnect discipline (reference watchdog.py:96-123: network
        # clients re-establish with capped retries). `reconnect` is the
        # max consecutive attempts per outage; 0 = fail loudly (bench
        # behavior). On success the full device state is re-programmed
        # from the host-side shadows and one gap line is logged.
        self._reconnect = int(reconnect)
        self._reconnect_wait = float(reconnect_wait)
        self.reconnects = 0
        self._dead_reason: str | None = None
        self._gain_db = gain_db          # None = tuner hardware AGC
        self._agc, self._bias = bool(agc), bool(bias_tee)
        self._sock = socket.create_connection((host, port),
                                              timeout=timeout)
        self._sock.settimeout(timeout)
        self._sock_lock = threading.Lock()
        self._cmdq: queue.Queue | None = None   # sync sends until started
        try:
            hdr = self._recv_exact(12)
            if hdr[:4] != MAGIC:
                raise ConnectionError(
                    f"{host}:{port} is not an rtl_tcp server "
                    f"(magic {hdr[:4]!r})")
        except BaseException:
            self._sock.close()           # no leaked sockets on a torn
            raise                        # handshake / stalled server
        self.tuner_type, self.tuner_gain_count = struct.unpack(
            ">II", hdr[4:])
        self.tuner = TUNER_NAMES.get(self.tuner_type, "UNKNOWN")
        self.rf_gain_db = 0.0
        self.ppm = 0.0
        self.antenna = "RX"
        self.direct_sampling = 0
        self.dropped = 0

        # device bring-up, reference setupSDR order (utils.py:292-353)
        try:
            self._cmd(CMD_SET_SAMPLE_RATE, int(round(fs)))
            if ppm:
                self.set_freq_correction(ppm)
            self.set_freq(fc)
            if gain_db is None:
                self._cmd(CMD_SET_GAIN_MODE, 0)      # tuner AGC
            else:
                self._cmd(CMD_SET_GAIN_MODE, 1)
                self.set_gain(gain_db)
            self._cmd(CMD_SET_AGC_MODE, 1 if agc else 0)
            if bias_tee:
                self._cmd(CMD_SET_BIAS_TEE, 1)
        except BaseException:
            self._sock.close()
            raise

        # SPSC byte ring drained by a reader thread. Invariant: every
        # ring write/read/drop is an EVEN byte count (whole I/Q pairs) —
        # an odd recv tail is held in _partial until its mate arrives —
        # so the cursors always sit on pair boundaries and drop-oldest
        # can never desync I from Q.
        self._ring = bytearray(ring_samples * 2)
        self._rsize = len(self._ring)
        self._w = 0                  # total bytes written (mono counter)
        self._r = 0                  # total bytes read
        self._partial = b""
        self._lock = threading.Lock()
        self._avail = threading.Condition(self._lock)
        self._stop = threading.Event()
        self._reconnecting = threading.Event()
        self._reconnect_s = 0.0          # total seconds in _re_establish
        self._reconnect_t0 = 0.0         # start of the one under way
        # Device commands are issued by a dedicated writer thread: the
        # executive's command queue only mutates host-side state, so a
        # stalled server / full TCP buffer can never block the DSP/audio
        # hot loop for the socket timeout (sendall can take seconds).
        self._cmdq = queue.Queue()
        self._writer = threading.Thread(target=self._write_loop,
                                        daemon=True)
        self._writer.start()
        self._thread = threading.Thread(target=self._pump, daemon=True)
        self._thread.start()

    # ---- protocol ----

    def _recv_exact(self, n: int, sock: socket.socket | None = None
                    ) -> bytes:
        sock = sock if sock is not None else self._sock
        buf = b""
        while len(buf) < n:
            chunk = sock.recv(n - len(buf))
            if not chunk:
                raise ConnectionError("rtl_tcp server closed")
            buf += chunk
        return buf

    def _cmd(self, cmd: int, value: int):
        pkt = struct.pack(">BI", cmd, value & 0xFFFFFFFF)
        if self._cmdq is None:           # constructor bring-up: sync
            self._sock.sendall(pkt)
        else:                            # running: never block the caller
            self._cmdq.put(pkt)

    def _write_loop(self):
        """Drains queued device commands onto the socket. A send failure
        is swallowed: the host-side shadow keeps the intended state and
        a reconnect re-programs the whole device from it. The send
        happens UNDER _sock_lock so it serializes against a reconnect's
        program-and-swap — a command arriving mid-reconnect lands on
        the new session instead of vanishing into the dead socket."""
        while not self._stop.is_set():
            try:
                pkt = self._cmdq.get(timeout=0.2)
            except queue.Empty:
                continue
            try:
                with self._sock_lock:
                    self._sock.sendall(pkt)
            except OSError:
                pass

    def _program(self, sock: socket.socket):
        """Full device bring-up on `sock` from the state shadows —
        the reference setupSDR order (utils.py:292-353), reused by both
        the constructor and every reconnect."""
        def send(cmd, value):
            sock.sendall(struct.pack(">BI", cmd, value & 0xFFFFFFFF))
        send(CMD_SET_SAMPLE_RATE, int(round(self.srate)))
        if self.ppm:
            send(CMD_SET_FREQ_CORR, int(round(self.ppm)))
        if self.direct_sampling:
            send(CMD_SET_DIRECT_SAMPLING, self.direct_sampling)
        send(CMD_SET_FREQ, int(round(self.fc)))
        if self._gain_db is None:
            send(CMD_SET_GAIN_MODE, 0)               # tuner AGC
        else:
            send(CMD_SET_GAIN_MODE, 1)
            send(CMD_SET_GAIN, int(round(self.rf_gain_db * 10.0)))
        send(CMD_SET_AGC_MODE, 1 if self._agc else 0)
        if self._bias:
            send(CMD_SET_BIAS_TEE, 1)

    def _re_establish(self, reason: str) -> bool:
        """Reconnect after `reason` (EOF / stall / socket error) with at
        most `self._reconnect` attempts; re-handshakes and re-programs
        srate/freq/gain/ppm from the device-model state. Returns True
        when streaming may resume; on exhaustion, logs loudly and marks
        the source dead so the consumer raises instead of masquerading
        as a clean end-of-stream."""
        self._partial = b""
        t0 = time.monotonic()
        # consumers' read timeouts are suspended while this is set: the
        # retry budget (attempts x connect-timeout + backoff) can span a
        # consumer's 10 s window, and the consumer aborting mid-retry
        # would make the configured budget unusable for real outages
        with self._avail:
            self._reconnect_t0 = t0
            self._reconnecting.set()
        try:
            return self._re_establish_attempts(reason, t0)
        finally:
            with self._avail:
                self._reconnect_s += time.monotonic() - t0
                self._reconnecting.clear()

    def _reconnect_seconds(self) -> float:
        """Seconds spent inside _re_establish so far, the one under way
        included. Call under self._avail."""
        if self._reconnecting.is_set():
            return self._reconnect_s + time.monotonic() - self._reconnect_t0
        return self._reconnect_s

    def _re_establish_attempts(self, reason: str, t0: float) -> bool:
        for attempt in range(1, self._reconnect + 1):
            if self._stop.is_set():
                return False
            try:
                self._sock.close()
            except OSError:
                pass
            sock = None
            try:
                sock = socket.create_connection(
                    (self._host, self._port), timeout=self._timeout)
                sock.settimeout(self._timeout)
                hdr = self._recv_exact(12, sock)
                if hdr[:4] != MAGIC:
                    raise ConnectionError(f"bad magic {hdr[:4]!r}")
                # program-and-swap under the lock: serializes against
                # the command writer thread (see _write_loop) and a
                # concurrent close()
                with self._sock_lock:
                    if self._stop.is_set():
                        sock.close()
                        return False
                    self._program(sock)
                    self._sock = sock
                self.reconnects += 1
                print(f"rtl_tcp: {reason}; reconnected to "
                      f"{self._host}:{self._port} after "
                      f"{time.monotonic() - t0:.1f} s "
                      f"(attempt {attempt}/{self._reconnect}), "
                      "device re-programmed", file=sys.stderr)
                return True
            except (OSError, ConnectionError):
                if sock is not None:
                    try:
                        sock.close()
                    except OSError:
                        pass
                # interruptible backoff: close() must not wait out a
                # multi-second retry sleep
                self._stop.wait(min(self._reconnect_wait * attempt, 5.0))
        self._dead_reason = (
            f"rtl_tcp: {reason}; gave up after {self._reconnect} "
            f"reconnect attempts over {time.monotonic() - t0:.1f} s "
            f"({self._host}:{self._port})")
        print(self._dead_reason, file=sys.stderr)
        return False

    # ---- Soapy-shaped device surface (reference utils.py:122-273) ----

    def set_freq(self, fc_hz: float):
        """Tune the dongle; auto-switches direct sampling below the
        tuner range like librtlsdr (reference receiver.py:671-680)."""
        want_ds = 2 if fc_hz < DIRECT_SAMPLING_BELOW_HZ else 0
        if want_ds != self.direct_sampling:
            self._cmd(CMD_SET_DIRECT_SAMPLING, want_ds)
            self.direct_sampling = want_ds
        self._cmd(CMD_SET_FREQ, int(round(fc_hz)))
        self.fc = float(fc_hz)

    def set_gain(self, db: float):
        self._cmd(CMD_SET_GAIN, int(round(db * 10.0)))
        self.rf_gain_db = float(db)
        # an explicit gain pins MANUAL mode, including across a
        # reconnect's _program replay (a device that started on tuner
        # AGC must not silently revert there after a server bounce)
        self._gain_db = float(db)

    def get_gain(self) -> float:
        return self.rf_gain_db

    def set_freq_correction(self, ppm: float):
        self._cmd(CMD_SET_FREQ_CORR, int(round(ppm)))
        self.ppm = float(ppm)

    def get_freq_correction(self) -> float:
        return self.ppm

    def set_antenna(self, name: str):
        self.antenna = name          # RTL has one port; carried as state

    def get_antenna(self) -> str:
        return self.antenna

    # ---- the stream ----

    def _pump(self):
        try:
            while not self._stop.is_set():
                try:
                    data = self._sock.recv(65536)
                except socket.timeout:
                    # a stalled server is NOT end-of-stream. With
                    # reconnect enabled, one full socket-timeout of
                    # silence from live hardware bounces the session;
                    # otherwise keep waiting so the consumer's own read
                    # timeout raises the loud TimeoutError instead of
                    # this thread silently closing the ring as EOF
                    if self._reconnect:
                        if self._re_establish("stall"):
                            continue
                        return               # retries exhausted
                    continue
                except OSError:
                    if self._reconnect and \
                            self._re_establish("socket error"):
                        continue
                    return
                if not data:
                    if self._reconnect and \
                            self._re_establish("server closed"):
                        continue
                    return
                data = self._partial + data
                if len(data) % 2:
                    self._partial = data[-1:]
                    data = data[:-1]
                else:
                    self._partial = b""
                if not data:
                    continue
                with self._avail:
                    if len(data) > self._rsize:
                        # one recv bigger than the whole ring: only the
                        # newest ring-full survives
                        cut = len(data) - self._rsize
                        self.dropped += cut // 2
                        data = data[cut:]
                    free = self._rsize - (self._w - self._r)
                    if len(data) > free:
                        # radio never back-pressures: drop OLDEST by
                        # advancing the read cursor (all quantities are
                        # even, so `need` is even and <= the backlog)
                        need = len(data) - free
                        self._r += need
                        self.dropped += need // 2
                    pos = self._w % self._rsize
                    first = min(len(data), self._rsize - pos)
                    self._ring[pos:pos + first] = data[:first]
                    if first < len(data):
                        self._ring[:len(data) - first] = data[first:]
                    self._w += len(data)
                    self._avail.notify_all()
        except OSError:
            pass
        finally:
            with self._avail:
                self._stop.set()
                self._avail.notify_all()

    def _read_bytes(self, nbytes: int, timeout: float) -> bytes:
        if nbytes > self._rsize:
            raise ValueError(
                f"block of {nbytes // 2} samples exceeds the "
                f"{self._rsize // 2}-sample ring: raise ring_samples or "
                "lower --block")
        with self._avail:
            ready = (lambda: (self._w - self._r) >= nbytes
                     or self._stop.is_set())
            # the timeout window counts only HEALTHY-connection silence:
            # the time the pump thread spends inside _re_establish is
            # left out (the retry budget is bounded on its own — on
            # exhaustion _pump exits, _stop is set and we fall through
            # to the dead-reason error below). The silence adds up over
            # the sessions a reconnect opens: the reference resets the
            # window at each reconnect, so a server that reconnects and
            # never sends data blocked this read forever (ROADMAP Queue
            # 3, fixed in this copy only)
            t0, r0 = time.monotonic(), self._reconnect_seconds()
            while not ready():
                self._avail.wait_for(ready, 0.25)
                if ready():
                    break
                silent = (time.monotonic() - t0
                          - (self._reconnect_seconds() - r0))
                if silent >= timeout:
                    # live hardware stalled: fail loudly rather than
                    # consuming a partial block and masquerading as EOF
                    raise TimeoutError(
                        f"rtl_tcp: no data for {timeout:.0f} s "
                        "(server/dongle stalled?)")
            if self._dead_reason is not None \
                    and (self._w - self._r) < nbytes:
                # reconnect retries exhausted: a dead radio is an
                # ERROR, not a clean end-of-stream (the r4 fail-loudly
                # invariant extends to the auto-reconnect path)
                raise ConnectionError(self._dead_reason)
            # stream ended: hand over whatever whole pairs remain
            have = min(nbytes, self._w - self._r)
            pos = self._r % self._rsize
            first = min(have, self._rsize - pos)
            out = bytes(self._ring[pos:pos + first]) + \
                bytes(self._ring[:have - first])
            self._r += have
            return out

    def read_data(self, n: int, loop: bool = True,
                  timeout: float = 10.0) -> np.ndarray:
        """n complex64 samples (blocks until available or stream end)."""
        p = self.read_packed(n, timeout)
        return p.view(np.complex64).reshape(-1)

    def read_packed(self, n: int, timeout: float = 10.0) -> np.ndarray:
        """Executive fast path: float32 (m, 2) packed re/im pairs."""
        raw = np.frombuffer(self._read_bytes(2 * n, timeout), np.uint8)
        return _cu8_to_pairs(raw)

    def close(self):
        # let in-flight device commands drain (bounded) before tearing
        # the socket down, so a set_gain immediately before close still
        # reaches the dongle
        if self._cmdq is not None:
            deadline = time.monotonic() + 1.0
            while not self._cmdq.empty() and time.monotonic() < deadline:
                time.sleep(0.01)
            time.sleep(0.02)             # writer may be mid-sendall
        self._stop.set()
        # first shutdown WITHOUT the lock: the writer thread may hold
        # _sock_lock inside sendall on a stalled server for the full
        # socket timeout, and shutdown() aborts that promptly — only
        # then is the locked teardown (serialized with a reconnect
        # swap) reachable without waiting out the timeout
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        with self._sock_lock:        # serialize with a reconnect swap
            try:
                self._sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            self._sock.close()
        if self._thread.is_alive():
            self._thread.join(timeout=2.0)
        if self._writer.is_alive():
            self._writer.join(timeout=2.0)


class FakeRtlTcpServer:
    """In-process rtl_tcp protocol server for hardware-free tests/CI:
    serves a caller-supplied IQ block (CU8-quantized, looped) and
    records every command it receives — the network analogue of the
    reference's fake RTL driver (utils.py:71-273)."""

    def __init__(self, iq: np.ndarray, tuner_type: int = 5,
                 gain_count: int = 29, chunk: int = 16384,
                 rate_sps: float | None = None, port: int = 0):
        """`port=0` picks an ephemeral port; pass a previous instance's
        `.port` to model a server bounce on the same address (the
        auto-reconnect tests)."""
        if np.asarray(iq).size == 0:
            raise ValueError("FakeRtlTcpServer needs a non-empty IQ "
                             "block to serve")
        from pysdr_tpu_torch.io.datfile import _quantize_iq
        self._payload = _quantize_iq(
            np.asarray(iq, np.complex64), "uint8").tobytes()
        self._hdr = MAGIC + struct.pack(">II", tuner_type, gain_count)
        self.commands: list[tuple[int, int]] = []
        self.chunk = chunk
        self.rate_sps = rate_sps          # None = as fast as TCP goes
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind(("127.0.0.1", port))
        self._srv.listen(1)
        self.port = self._srv.getsockname()[1]
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._serve, daemon=True)
        self._thread.start()

    def _serve(self):
        import time
        self._srv.settimeout(0.2)
        conn = None
        while not self._stop.is_set() and conn is None:
            try:
                conn, _ = self._srv.accept()
            except socket.timeout:
                continue
        if conn is None:
            return
        conn.sendall(self._hdr)
        conn.settimeout(0.05)
        pos = 0
        cmdbuf = b""
        try:
            while not self._stop.is_set():
                try:
                    while True:
                        data = conn.recv(4096)
                        if data == b"":
                            return
                        # commands may straddle recv boundaries: buffer
                        # and parse whole 5-byte units
                        cmdbuf += data
                        while len(cmdbuf) >= 5:
                            c, v = struct.unpack(">BI", cmdbuf[:5])
                            self.commands.append((c, v))
                            cmdbuf = cmdbuf[5:]
                except socket.timeout:
                    pass
                end = min(pos + self.chunk * 2, len(self._payload))
                conn.sendall(self._payload[pos:end])
                if self.rate_sps:
                    time.sleep((end - pos) / 2 / self.rate_sps)
                pos = end % len(self._payload)
        except OSError:
            pass
        finally:
            conn.close()

    def stop(self):
        self._stop.set()
        self._thread.join(timeout=2.0)
        self._srv.close()
