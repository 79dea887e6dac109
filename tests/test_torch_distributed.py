"""Two processes of the port's torch.distributed harness (gloo, 4 CPU
devices each) run the sharded processors over the global grid and must
agree on every digest: the stream halo crosses the process boundary by
send/recv, the carried state by broadcast (mirror of
tests/test_distributed.py)."""

import os
import re
import socket
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.mark.slow
def test_two_process_mesh():
    port = _free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = []
    for pid in range(2):
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "pysdr_tpu_torch.parallel.distributed",
             "--coordinator", f"127.0.0.1:{port}", "--nprocs", "2",
             "--proc-id", str(pid), "--cpu-devices", "4",
             "--demo", "both", "--n-stream", "2"],
            cwd=REPO, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=420)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("distributed demo timed out")
        outs.append(out)
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out
    digests = {}
    for out in outs:
        for kind, d in re.findall(
                r"distributed (rx|chan|streaming) ok: .*digest=([0-9.]+)",
                out):
            digests.setdefault(kind, set()).add(d)
    assert {"rx", "chan", "streaming"} <= set(digests), outs
    # every process computed the same global result
    assert all(len(v) == 1 for v in digests.values()), digests
