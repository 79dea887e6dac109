"""The port's runtime on the CPU: the executive's host copies drain
the same audio and baseband as the serial bank at every pipeline depth,
an rtl_tcp server that keeps reconnecting without data ends the read in
TimeoutError, the probe dumps an rtl_tcp server, and the latency
analyzer reads the CSV the port's --watchdog-log writes (mirrors of
tests/test_runtime.py:218-309 and tests/test_rtltcp.py:154-167)."""

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
