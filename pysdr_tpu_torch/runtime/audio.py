"""Audio sink layer: paced playback from ring buffers + output routing.

Functional equivalent of the reference's `audio_io.AudioIO` (created at
reference receiver.py:837-874, driven by `audio_out` receiver.py:153-225):
a player object consumes an audio ring buffer in fixed chunks at the audio
clock rate and pushes frames to an output device. Here the "device" is a
pluggable sink (wav file, callback into another process, or discard) since
the TPU host has no sound card; the pacing, watermark-deferred start,
pause/resume/stop lifecycle, stereo packing and gain laws all mirror the
reference:

  * playback starts only after `delay` samples are buffered
    (reference receiver.py:224-225, P.DELAY = 16*1024);
  * dB-style AF gain law `10**g - 1` (reference receiver.py:171);
  * scheme-2 stereo packing of two RXs into L/R as `am1*g1 + 1j*am2*g2`
    (reference receiver.py:158-189);
  * aux speaker path through an 800-1300 Hz bandpass
    (reference receiver.py:214-221);
  * underrun inserts silence and is counted (the watchdog's low-water
    push_zeros behavior, reference watchdog.py:188-201).

The port's own copy of pysdr_tpu/runtime/audio.py, with its imports
rewritten to pysdr_tpu_torch: the port imports nothing of the JAX package.
"""

from __future__ import annotations

import threading
import time
from typing import Callable

import numpy as np

from pysdr_tpu_torch.ops import fir
from pysdr_tpu_torch.runtime.ringbuffer import RingBuffer

CHUNK = 1024          # reference OUT_CHUNK_SIZE (params.py:440)
DEFAULT_DELAY = 16 * CHUNK   # reference P.DELAY (params.py:70-71)


def af_gain_linear(gain_setting: float) -> float:
    """GUI slider -> linear gain, the reference's dB-ish law
    `pow(10, AF_GAIN) - 1` (receiver.py:171)."""
    return 10.0 ** gain_setting - 1.0


def pack_stereo(am1: np.ndarray, am2: np.ndarray, g1: float = 1.0,
                g2: float = 1.0) -> np.ndarray:
    """Two mono RX streams -> one complex stereo stream L+jR
    (reference receiver.py:158-189)."""
    return (g1 * am1.real + 1j * (g2 * am2.real)).astype(np.complex64)


def aux_bandpass_taps(fs: float, ntaps: int = 257) -> np.ndarray:
    """800-1300 Hz speech-peak bandpass for the aux speaker path
    (reference receiver.py:214-221). 257 taps @ 48 kHz puts the 400 Hz
    stopband below -60 dB (129 leaves it at only -18 dB)."""
    return np.asarray(fir.bandpass(800.0, 1300.0, fs, ntaps), np.float32)


class WavSink:
    """File sink with the wave module; int16, mono or stereo."""

    def __init__(self, path: str, fs: float, stereo: bool = True):
        import wave
        self._w = wave.open(path, "wb")
        self._w.setnchannels(2 if stereo else 1)
        self._w.setsampwidth(2)
        self._w.setframerate(int(round(fs)))
        self.stereo = stereo
        self.path = path

    def write(self, frames: np.ndarray):
        a = frames
        if np.iscomplexobj(a):
            a = np.stack([a.real, a.imag], -1) if self.stereo \
                else a.real[:, None]
        elif a.ndim == 1:
            a = a[:, None]
            if self.stereo:
                a = np.repeat(a, 2, axis=1)
        pcm = (np.clip(a, -1, 1) * 32767.0).astype("<i2")
        self._w.writeframes(pcm.tobytes())

    def close(self):
        self._w.close()


class NullSink:
    def write(self, frames):
        pass

    def close(self):
        pass


class FifoSink:
    """Loopback routing: raw s16le PCM into a named pipe so other apps
    (fldigi, wsjtx, digimode decoders) can consume the audio — the
    functional equivalent of the reference's PulseAudio loopback module
    (reference start_loopback:1-100). Non-blocking: frames are dropped
    while no reader is attached (a loopback never back-pressures the
    radio), and the pipe is (re)opened lazily when a reader appears."""

    def __init__(self, path: str, fs: float, stereo: bool = False):
        import os
        import stat
        self.path, self.fs, self.stereo = path, fs, stereo
        if not (os.path.exists(path)
                and stat.S_ISFIFO(os.stat(path).st_mode)):
            os.mkfifo(path)
        self._fd = None
        self.dropped = 0
        # Unwritten tail carried between calls: pipe writes larger than
        # PIPE_BUF are not atomic, so os.write can return a short (even
        # odd-byte) count. Losing that tail would byte-desync the s16le
        # stream for every downstream decoder, so it is buffered and
        # flushed ahead of the next block (capped; overflow drops whole
        # frames only, which keeps the stream frame-aligned).
        self._pending = b""
        self._max_pending = 1 << 18      # 256 KiB ≈ 2.7 s mono @ 48 kHz

    def _ensure_open(self) -> bool:
        import errno
        import os
        if self._fd is not None:
            return True
        try:
            self._fd = os.open(self.path, os.O_WRONLY | os.O_NONBLOCK)
            return True
        except OSError as e:
            if e.errno == errno.ENXIO:      # no reader yet
                return False
            raise

    def write(self, frames: np.ndarray):
        import errno
        import os
        a = frames
        if np.iscomplexobj(a):
            a = np.stack([a.real, a.imag], -1) if self.stereo \
                else a.real[:, None]
        elif a.ndim == 1:
            a = a[:, None]
        pcm = (np.clip(a, -1, 1) * 32767.0).astype("<i2").tobytes()
        frame_bytes = 4 if self.stereo else 2
        if not self._ensure_open():
            self.dropped += len(frames)
            return
        buf = self._pending + pcm
        try:
            n = os.write(self._fd, buf)
        except BlockingIOError:
            n = 0
        except OSError as e:
            if e.errno == errno.EPIPE:      # reader went away
                os.close(self._fd)
                self._fd = None
                self._pending = b""
                self.dropped += len(frames)
                return
            raise
        rest = buf[n:]
        if len(rest) > self._max_pending:
            # Reader persistently slow: shed the newest data in whole
            # frames so delivered bytes stay a multiple of the frame size.
            drop = len(rest) - self._max_pending
            drop += (-drop) % frame_bytes
            rest = rest[:len(rest) - drop]
            self.dropped += drop // frame_bytes
        self._pending = rest

    def close(self):
        import os
        if self._fd is not None:
            os.close(self._fd)
            self._fd = None


class TeeSink:
    """Fan one audio stream out to several sinks (wav + fifo, ...)."""

    def __init__(self, *sinks):
        self.sinks = [s for s in sinks if s is not None]

    def write(self, frames):
        for s in self.sinks:
            s.write(frames)

    def close(self):
        for s in self.sinks:
            s.close()


class CallbackSink:
    def __init__(self, fn: Callable[[np.ndarray], None]):
        self.fn = fn

    def write(self, frames):
        self.fn(frames)

    def close(self):
        pass


class AudioPlayer:
    """Paced consumer of one audio ring buffer.

    Lifecycle mirrors the reference AudioIO: `start_playback(nsamps)`
    defers until the ring holds nsamps; pause/resume gate consumption
    without losing position; stop ends the thread. `realtime=False`
    drains as fast as the producer fills (offline/bench mode).
    """

    def __init__(self, ring: RingBuffer, fs: float, sink=None,
                 chunk: int = CHUNK, realtime: bool = True, tag: str = ""):
        self.rb = ring
        self.fs = fs
        self.sink = sink or NullSink()
        self.chunk = chunk
        self.realtime = realtime
        self.tag = tag
        self.active = False
        self.start_time: float | None = None
        self.underruns = 0
        self.frames_out = 0
        self._pause = threading.Event()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    # -- lifecycle (reference receiver.py:470-474; gui.py:725-735) --

    def start_playback(self, min_buffered: int = DEFAULT_DELAY,
                       timeout: float = 10.0):
        """Begin playback once the ring holds min_buffered samples."""
        deadline = time.monotonic() + timeout
        while self.rb.nsamps < min(min_buffered, self.rb.size // 2):
            if time.monotonic() > deadline:
                break
            time.sleep(0.005)
        self.start_time = time.time()
        self.active = True
        self._stop.clear()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        return self

    def pause(self):
        self._pause.set()

    def resume(self):
        self._pause.clear()

    def stop(self, drain: bool = False):
        if drain:
            while self.rb.nsamps >= self.chunk and self.active:
                time.sleep(0.002)
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=2.0)
        self.active = False
        self.sink.close()

    # -- the pump --

    def _run(self):
        period = self.chunk / self.fs
        next_t = time.monotonic()
        while not self._stop.is_set():
            if self._pause.is_set():
                time.sleep(period)
                next_t = time.monotonic()
                continue
            if self.rb.ready(self.chunk):
                frames = self.rb.pull(self.chunk)
            elif self.realtime:
                # underrun: emit silence, keep the clock (watchdog
                # low-water behavior)
                frames = np.zeros(self.chunk, np.complex64)
                self.underruns += 1
            else:
                time.sleep(0.001)
                continue
            self.sink.write(frames)
            self.frames_out += self.chunk
            if self.realtime:
                next_t += period
                dt = next_t - time.monotonic()
                if dt > 0:
                    time.sleep(dt)
                else:
                    next_t = time.monotonic()
        self.active = False


class StereoPairRing:
    """Read-side adapter packing two mono RX rings into one stereo stream
    L+jR at pull time (the reference's scheme-2 two-RXs-per-player
    routing `am1*g1 + 1j*am2*g2`, receiver.py:158-189). Presents the
    consumer subset of the RingBuffer API so AudioPlayer's pacing and
    underrun logic work unchanged."""

    def __init__(self, left: RingBuffer, right: RingBuffer,
                 g1: float = 1.0, g2: float = 1.0):
        self.left, self.right = left, right
        self.g1, self.g2 = g1, g2
        self.tag = f"{left.tag}+{right.tag}"

    @property
    def nsamps(self) -> int:
        return min(self.left.nsamps, self.right.nsamps)

    @property
    def size(self) -> int:
        return min(self.left.size, self.right.size)

    def ready(self, n: int) -> bool:
        return self.left.ready(n) and self.right.ready(n)

    def pull(self, n: int) -> np.ndarray:
        return pack_stereo(self.left.pull(n), self.right.pull(n),
                           self.g1, self.g2)


def create_players(bank, rings, fs: float, wav_prefix: str | None = None,
                   stereo_pairs: bool = False, realtime: bool = True):
    """Build one player per RX — or one per RX *pair* packed into stereo
    (the reference's scheme-2 two-RXs-per-player routing,
    receiver.py:158-189 via create_Audio_Players receiver.py:837-874).
    With stereo_pairs, even/odd rings feed one player through a
    StereoPairRing (RX i in L, RX i+1 in R); a trailing odd RX stays mono.
    """
    players = []
    step = 2 if stereo_pairs else 1
    for i in range(0, len(rings), step):
        ring = rings[i]
        if stereo_pairs and i + 1 < len(rings):
            ring = StereoPairRing(rings[i], rings[i + 1])
        sink = WavSink(f"{wav_prefix}_rx{i}.wav", fs) if wav_prefix \
            else NullSink()
        players.append(AudioPlayer(ring, fs, sink=sink,
                                   realtime=realtime, tag=f"play{i}"))
    return players
