"""The port's runtime on the CPU: the executive's host copies drain
the same audio and baseband as the serial bank at every pipeline depth,
each drained baseband carries its events and, for the recorder and the
BB panes, its host copy (the recorded bytes as before),
an rtl_tcp server that keeps reconnecting without data ends the read in
TimeoutError, the probe dumps an rtl_tcp server, and the latency
analyzer reads the CSV the port's --watchdog-log writes (mirrors of
tests/test_runtime.py:218-309 and tests/test_rtltcp.py:154-167), and
the Stopwatch against the JAX package's."""

import os
import socket
import threading
import time

import numpy as np
import pytest
import torch

from pysdr_tpu_torch import app, latency, probe
from pysdr_tpu_torch.config import PipelineConfig, ReceiverConfig
from pysdr_tpu_torch.io import rtltcp
from pysdr_tpu_torch.models.receiver import ReceiverBank
from pysdr_tpu_torch.runtime.executive import Executive
from pysdr_tpu_torch.tables import Mode

torch.set_num_threads(1)


class RampSource:
    """Consecutive blocks whose amplitude grows with the block index."""

    def __init__(self):
        self.k = 0

    def read_data(self, n, loop=True):
        t = np.arange(n) / 512e3
        self.k += 1
        return (0.05 * self.k * np.exp(2j * np.pi * 60e3 * t)
                * (1 + 0.3 * np.sin(2 * np.pi * 500 * t))).astype(np.complex64)


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_host_copy_drain_same_audio_at_depths(depth):
    """Every drained block's audio and baseband equal the serial bank's
    for that block, in order."""
    cfg = PipelineConfig(fs_in=512e3, fs_out=48e3, out_block=1024,
                         foffset_hz=60e3, receivers=(
                             ReceiverConfig(fc_hz=10e6, mode=Mode.AM,
                                            agc_enabled=False),
                             ReceiverConfig(fc_hz=10.02e6, mode=Mode.USB)))
    n_blocks = 7
    serial = ReceiverBank(cfg, emit_baseband=True, audio_wire="i16",
                          device="cpu")
    src = RampSource()
    ref_audio, ref_bb = [], []
    for _ in range(n_blocks):
        ref_audio.append(serial.step(src.read_data(serial.design.in_block)))
        ref_bb.append(serial._last_bb.clone())
    got = []

    def tap(ex, audio):
        got.append((audio.copy(), ex.drained_bb))

    ex = Executive(ReceiverBank(cfg, emit_baseband=True, audio_wire="i16",
                                device="cpu"), RampSource(),
                   psd_callback=tap, pipeline_depth=depth)
    ex.run(n_blocks=n_blocks)
    ex.stop()
    assert len(got) == n_blocks
    for k, (audio, bb) in enumerate(got):
        np.testing.assert_array_equal(audio, ref_audio[k])
        assert bb.device.type == "cpu"
        np.testing.assert_array_equal(bb.numpy(), ref_bb[k].numpy())
    pulled = ex.audio_rings[1].pull(n_blocks * serial.design.out_block)
    np.testing.assert_array_equal(
        pulled, np.concatenate([a[1] for a in ref_audio]))


@pytest.mark.parametrize("host_bb", [False, True])
def test_drained_baseband_carries_its_events_and_host_copy(host_bb):
    """Each drained entry carries the block's baseband, the events after
    which it is valid (none on the CPU) and, with host_bb, its host copy,
    started at dispatch beside the audio's: equal to the serial bank's
    baseband of that block."""
    cfg = PipelineConfig(fs_in=512e3, fs_out=48e3, out_block=1024,
                         foffset_hz=60e3, receivers=(
                             ReceiverConfig(fc_hz=10e6, mode=Mode.AM),
                             ReceiverConfig(fc_hz=10.02e6, mode=Mode.USB)))
    n_blocks = 5
    serial = ReceiverBank(cfg, emit_baseband=True, device="cpu")
    src = RampSource()
    ref = []
    for _ in range(n_blocks):
        serial.step(src.read_data(serial.design.in_block))
        ref.append(serial._last_bb.clone())
    got = []

    def tap(ex, audio):
        got.append((ex.drained_bb, ex.drained_bb_ready, ex.drained_bb_host))

    ex = Executive(ReceiverBank(cfg, emit_baseband=True, device="cpu"),
                   RampSource(), psd_callback=tap, pipeline_depth=2,
                   host_bb=host_bb)
    ex.run(n_blocks=n_blocks)
    ex.stop()
    assert len(got) == n_blocks
    for k, (bb, ready, bb_host) in enumerate(got):
        np.testing.assert_array_equal(bb.numpy(), ref[k].numpy())
        assert list(ready) == []
        if host_bb:
            assert bb_host.device.type == "cpu" and bb_host is not bb
            np.testing.assert_array_equal(bb_host.numpy(), ref[k].numpy())
        else:
            assert bb_host is None


def test_recorded_baseband_bytes_as_the_device_baseband_gives(tmp_path):
    """--save-baseband with --bb: the recorder writes the baseband's host
    copy that the executive started at dispatch, byte for byte what the
    drained device baseband gives (as `bb.cpu().numpy()` wrote it), and
    the BB panes update from it."""
    from pysdr_tpu_torch.io import datfile
    a = app.App(app.build_parser().parse_args(
        ["--device", "cpu", "--fs", "0.512", "--block", "1024", "--blocks",
         "3", "--save-baseband", "--save-dir", str(tmp_path), "--bb",
         "--psd-every", "1"]))
    assert a.ex.host_bb and a.ex.want_bb
    drained = []
    hook = a.ex.psd_callback

    def tap(ex, audio):
        drained.append(ex.drained_bb.clone())
        hook(ex, audio)
    a.ex.psd_callback = tap
    assert a.run() == 0
    names = [f for f in os.listdir(tmp_path) if f.startswith("baseband")]
    assert len(names) == 1 and len(drained) == 3
    with open(tmp_path / names[0], "rb") as f:
        raw = f.read()
    hdr_len = int(np.frombuffer(raw[8:12], "<u4")[0])
    assert raw[:8] == datfile.MAGIC
    want = b"".join(np.ascontiguousarray(bb.cpu().numpy().T).tobytes()
                    for bb in drained)
    assert raw[12 + hdr_len:] == want
    assert a.display.frames["BB0"].waterfall_u8.shape[1] == 1024


class SlowSource(RampSource):
    """RampSource whose reads take 50 ms, as a large block's read and
    quantize do."""

    def read_data(self, n, loop=True):
        time.sleep(0.05)
        return super().read_data(n, loop)


def test_stop_waits_for_the_prefetch_thread():
    """stop() returns with the prefetch thread gone, though the thread
    was reading ahead when the run ended: a process exiting right after
    stop() finds no thread of the executive inside a copy."""
    cfg = PipelineConfig(fs_in=512e3, fs_out=48e3, out_block=1024,
                         foffset_hz=60e3, receivers=(
                             ReceiverConfig(fc_hz=10e6, mode=Mode.AM),))
    ex = Executive(ReceiverBank(cfg, device="cpu"), SlowSource())
    ex.run(n_blocks=3)
    t = ex._pf_thread
    assert t is not None and t.is_alive()
    ex.stop()
    assert not t.is_alive()
    assert ex.n_blocks == 3


class GatedSource(RampSource):
    """RampSource whose reads after the first `n_open` wait for `gate`."""

    def __init__(self, n_open):
        super().__init__()
        self.n_open = n_open
        self.gate = threading.Event()
        self.waiting = threading.Event()

    def read_data(self, n, loop=True):
        if self.k >= self.n_open:
            self.waiting.set()
            self.gate.wait()
        return super().read_data(n, loop)


def test_a_read_that_outlasts_stop_issues_nothing():
    """A prefetch read still in progress when stop() is called (a source
    slower than stop's wait) ends without issuing its block: after stop()
    the executive's thread makes no device call, so another bank's graph
    capture can start at once."""
    cfg = PipelineConfig(fs_in=512e3, fs_out=48e3, out_block=1024,
                         foffset_hz=60e3, receivers=(
                             ReceiverConfig(fc_hz=10e6, mode=Mode.AM),))
    src = GatedSource(n_open=4)
    ex = Executive(ReceiverBank(cfg, device="cpu"), src)
    issued = []
    prepare = ex._prepare
    ex._prepare = lambda pair: (issued.append(1), prepare(pair))[1]
    ex.run(n_blocks=3)
    assert src.waiting.wait(timeout=10.0)      # the 5th read has begun
    n_issued = len(issued)
    release = threading.Timer(0.2, src.gate.set)
    release.start()
    ex.stop()
    release.join()
    ex._pf_thread.join(timeout=10.0)
    assert not ex._pf_thread.is_alive()
    assert src.k == 5 and len(issued) == n_issued == 4


class ReconnectingServer(rtltcp.FakeRtlTcpServer):
    """An rtl_tcp server that takes every connection, sends its header
    0.3 s later and then never a sample."""

    def _serve(self):
        self._srv.settimeout(0.1)
        conns = []
        while not self._stop.is_set():
            try:
                conn, _ = self._srv.accept()
            except socket.timeout:
                continue
            time.sleep(0.3)
            try:
                conn.sendall(self._hdr)
            except OSError:
                pass
            conns.append(conn)
        for conn in conns:
            conn.close()


def test_rtltcp_reconnecting_server_without_data_times_out():
    """ROADMAP Queue 3: the read's window counts the healthy-connection
    silence across reconnects, so a server that reconnects and never
    sends data ends the read in TimeoutError (the JAX copy restarts the
    window at each reconnect and waits forever)."""
    srv = ReconnectingServer(np.ones(16, np.complex64))
    src = rtltcp.RtlTcpSource("127.0.0.1", srv.port, fs=256e3, fc=100e6,
                              timeout=0.6, reconnect=1000,
                              reconnect_wait=0.05)
    result = []

    def read():
        t0 = time.monotonic()
        try:
            src.read_data(1 << 12, timeout=1.0)
            result.append(("data", time.monotonic() - t0))
        except (TimeoutError, ConnectionError) as e:
            result.append((type(e).__name__, time.monotonic() - t0))
    t = threading.Thread(target=read, daemon=True)
    t.start()
    try:
        t.join(timeout=15.0)
        assert not t.is_alive(), "read still blocked after 15 s"
        assert result[0][0] == "TimeoutError", result
        assert src.reconnects >= 1
    finally:
        src.close()
        srv.stop()


def test_probe_rtl_tcp(capsys):
    """python -m pysdr_tpu_torch.probe --rtl-tcp dumps the server's
    identity and a stream sample."""
    fs = 256e3
    t = np.arange(1 << 15) / fs
    srv = rtltcp.FakeRtlTcpServer(
        (0.4 * np.exp(2j * np.pi * 60e3 * t)).astype(np.complex64))
    try:
        rc = probe.main(["--device", "cpu", "--rtl-tcp",
                         f"127.0.0.1:{srv.port}"])
        out = capsys.readouterr().out
        assert rc == 0
        assert "tuner=R820T" in out and "rms=" in out
    finally:
        srv.stop()


def test_latency_analyzer_on_the_port_watchdog(tmp_path, capsys):
    """The port's watchdog CSV through the port's analyzer: p50/p95 and
    the self-heal events (tests/test_runtime.py:218-252)."""
    from pysdr_tpu_torch.runtime.ringbuffer import RingBuffer
    from pysdr_tpu_torch.runtime.watchdog import WatchDog
    log = str(tmp_path / "LOG2.TXT")
    rb = RingBuffer("audio0", 4800, "complex64")
    wd = WatchDog(rb, fs=48e3, log_path=log, low=0.25, high=0.75)
    for n in (2000, 2400, 2600):
        rb.clear()
        rb.push(np.zeros(n, np.complex64))
        wd.check_once()
    rb.clear()
    rb.push(np.zeros(100, np.complex64))
    wd.check_once()
    rb.push(np.zeros(4500, np.complex64))
    wd.check_once()
    wd.stop()
    s = latency.analyze(log)["audio0"]
    assert s["n_samples"] == 5
    assert 0.0 < s["latency_p50_s"] <= s["latency_p95_s"] \
        <= s["latency_max_s"]
    assert s["zero_fills"] == 1 and s["zeroed_samples"] > 0
    assert s["drops"] == 1 and s["dropped_samples"] > 0
    assert latency.main([log]) == 0
    out = capsys.readouterr().out
    assert "audio0" in out and "p95" in out


def test_app_watchdog_log_flag(tmp_path):
    """--watchdog-log threads the CSV path into the realtime watchdogs
    (tests/test_runtime.py:255-267)."""
    import os
    log = str(tmp_path / "wd.csv")
    rc, _ = app.run_cli(["--device", "cpu", "--fs", "0.512", "--block",
                         "4096", "--blocks", "3", "--realtime",
                         "--watchdog-log", log])
    assert rc == 0 and os.path.exists(log)
    assert latency.analyze(log) is not None


def test_stopwatch_matches_the_reference():
    """The port's Stopwatch accumulates like the JAX package's."""
    from pysdr_tpu.runtime import profiler as jprof
    from pysdr_tpu_torch.runtime.profiler import Stopwatch
    sw, jsw = Stopwatch("blk"), jprof.Stopwatch("blk")
    for _ in range(3):
        for w in (sw, jsw):
            w.start()
        time.sleep(0.01)
        dts = [w.stop() for w in (sw, jsw)]
        assert all(0.009 <= d < 1.0 for d in dts)
    assert (sw.tag, sw.count) == (jsw.tag, jsw.count) == ("blk", 3)
    assert 0.027 <= sw.total_s < 3.0 and 0.027 <= jsw.total_s < 3.0
