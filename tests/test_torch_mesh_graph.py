"""The --mesh adapters over static buffers (parallel/adapter.py over
parallel/stream.py stream_split and parallel/chanshard.py
channelizer_split): the body each shard's CUDA graph captures, on the
CPU, where it runs as it is. On grids of the CPU device repeated, twelve
super-blocks of numpy-seeded stations, with retune, set_mode (AM -> NFM
-> USB), set_squelch and set_agc posted between calls:

  * the adapter (graph=False) is bit-equal to the functional processor
    (make_streaming_processor, make_channelizer_streaming_processor) on
    the same blocks: every audio piece and every carried tensor;
  * it is >= 80 dB per channel against the JAX package's streaming
    processors (pysdr_tpu/parallel/stream.py:136, chanshard.py:180) on
    its 8-virtual-device CPU mesh, the carried phase bases bit-equal.

Then the bookkeeping a replay relies on: rebinding the bank's params or
the adapter's carried state after `prepare` raises at the next call; and
with the capture emulated on the CPU (a graph whose replay runs the
captured body), the adapters and StepGraphs go through
models/graphstep.capture: one graph a shard, each replay checked and its
launches counted, the executive at depths 1 and 2 draining the same
audio as the functional processor.

The real graphs, their replays and launches run on the card:
tests/test_torch_kernels.py and chip_smoke.py phase 10."""

import ctypes
import gc

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pysdr_tpu import config as jconfig
from pysdr_tpu import tables as jtables
from pysdr_tpu.models.channelizer_bank import ChannelizerBank as JaxChanBank
from pysdr_tpu.models.channelizer_bank import \
    ChannelizerBankConfig as JaxChanConfig
from pysdr_tpu.models.channelizer_bank import ChannelSettings as JaxSettings
from pysdr_tpu.models.receiver import ReceiverBank as JaxBank
from pysdr_tpu.ops import cplx as jcplx
from pysdr_tpu.parallel import chanshard as jchanshard
from pysdr_tpu.parallel import mesh as jmesh
from pysdr_tpu.parallel import stream as jstream
from pysdr_tpu_torch import config, kernels, tables
from pysdr_tpu_torch.device import leaves, map_tensors
from pysdr_tpu_torch.kernels import scan as kscan
from pysdr_tpu_torch.models import graphstep
from pysdr_tpu_torch.models.channelizer_bank import (ChannelizerBank,
                                                     ChannelizerBankConfig,
                                                     ChannelSettings)
from pysdr_tpu_torch.models.receiver import ReceiverBank
from pysdr_tpu_torch.ops import cplx
from pysdr_tpu_torch.parallel import adapter as adapter_mod
from pysdr_tpu_torch.parallel import chanshard, stream
from pysdr_tpu_torch.parallel import mesh as mesh_mod
from pysdr_tpu_torch.parallel.adapter import (ShardedChannelizerBank,
                                              ShardedStreamBank, build_mesh)
from pysdr_tpu_torch.runtime.executive import Executive

torch.set_num_threads(1)
# the tests' segments are shorter than the 0.2 s settle halo, by design
pytestmark = pytest.mark.filterwarnings("ignore:stream segment")


@pytest.fixture(autouse=True, scope="module")
def release_heap():
    """After this module, give its freed heap back to the OS, so that the
    next test module in this worker process (tests/test_parity.py's RSS
    growth check among them) starts without megabytes of free but
    resident heap that a new allocation would reuse unseen."""
    yield
    gc.collect()
    getattr(ctypes.CDLL(None), "malloc_trim", lambda pad: 0)(0)


N_CALLS = 12
N_CH = 8
# bank4's stations: each RX's offset from the passband's center and what
# it sends
BANK4_OFFSETS = [60e3, 90e3, 30e3, 120e3]
BANK4_KINDS = ["am", "fm", "usb", "am"]
BANK_GRIDS = [(1, 1), (2, 1), (2, 2)]
CHAN_GRIDS = [(1, 4), (2, 2)]


def bank4_cfg(cfg_mod, Mode):
    """A 4-RX bank at the tests' small size, in either package."""
    return cfg_mod.PipelineConfig(
        fs_in=512e3, fs_out=48e3, out_block=1536, foffset_hz=60e3,
        receivers=(
            cfg_mod.ReceiverConfig(fc_hz=10e6, mode=Mode.AM),
            cfg_mod.ReceiverConfig(fc_hz=10.03e6, mode=Mode.NFM),
            cfg_mod.ReceiverConfig(fc_hz=9.97e6, mode=Mode.USB),
            cfg_mod.ReceiverConfig(fc_hz=10.06e6, mode=Mode.CW)))


def chan_cfg(cfg_cls, set_cls, Mode):
    """An 8-channel bank at 192 kHz a channel, in either package."""
    return cfg_cls(fs_in=N_CH * 192e3, n_channels=N_CH, fs_out=48e3,
                   out_block=1024, fc_hz=100e6,
                   channels=tuple(set_cls(mode=Mode.AM)
                                  for _ in range(N_CH)))


def stations(offsets, kinds, fs, n, n_blocks, seed):
    """n_blocks consecutive complex64 blocks of n samples: one station an
    offset ("am": a 50 % tone; "fm": 3 kHz deviation; "usb": the tone
    above the carrier), tones 500 + 150 i Hz, over numpy-seeded noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(n * n_blocks) / fs
    x = 0.02 * (rng.standard_normal(t.size)
                + 1j * rng.standard_normal(t.size))
    for i, (off, kind) in enumerate(zip(offsets, kinds)):
        fa = 500.0 + 150.0 * i
        car = np.exp(2j * np.pi * off * t)
        if kind == "am":
            x += 0.2 * (1 + 0.5 * np.sin(2 * np.pi * fa * t)) * car
        elif kind == "fm":
            x += 0.2 * car * np.exp(1j * 3e3 / fa
                                    * np.sin(2 * np.pi * fa * t))
        else:
            x += 0.2 * car * np.exp(2j * np.pi * fa * t)
    return [b.astype(np.complex64) for b in np.split(x, n_blocks)]


def snr_db(got, ref):
    err = (np.abs(got - ref) ** 2).mean()
    return -10 * np.log10(max(err / max((np.abs(ref) ** 2).mean(), 1e-30),
                              1e-30))


def bank4_controls(b, Mode, k):
    """The control changes posted before call k of the bank4 run: RX 0
    goes AM -> NFM -> USB -> AM."""
    if k == 3:
        b.retune(1, 10.031e6)
        b.set_mode(0, Mode.NFM)
    elif k == 5:
        b.set_mode(0, Mode.USB)
        b.set_squelch(2, 3.0)
    elif k == 7:
        b.set_agc(3, False)
        b.retune(2, 9.971e6)
    elif k == 9:
        b.set_mode(0, Mode.AM)
        b.set_agc(3, True)
        b.set_squelch(2, -150.0)


def chan_controls(b, Mode, k):
    """The control changes posted before call k of the channel run:
    channel 5 goes AM -> NFM -> USB -> AM."""
    if k == 3:
        b.retune(2, 4e3)
        b.set_mode(5, Mode.NFM)
    elif k == 5:
        b.set_mode(5, Mode.USB)
        b.set_squelch(1, 3.0)
    elif k == 7:
        b.set_agc(6, False)
        b.retune(2, 0.0)
    elif k == 9:
        b.set_mode(5, Mode.AM)
        b.set_agc(6, True)


def cpu_grid(s, c):
    return build_mesh(s, c, device="cpu")


def make_case(kind, grid, graph=False):
    """(adapter, functional process and its carried state, JAX process
    and its carried state, the JAX bank, super-blocks, control function,
    the port bank the functional process reads)."""
    s, c = grid
    if kind == "bank":
        tb = ReceiverBank(bank4_cfg(config, tables.Mode), device="cpu")
        fb = ReceiverBank(bank4_cfg(config, tables.Mode), device="cpu")
        jb = JaxBank(bank4_cfg(jconfig, jtables.Mode))
        seg = tb.design.in_block
        ad = ShardedStreamBank(tb, cpu_grid(s, c), graph=graph)
        proc, halo = stream.make_streaming_processor(fb, cpu_grid(s, c), seg)
        jproc, jhalo = jstream.make_streaming_processor(
            jb, jmesh.make_mesh(s, c), seg)
        xs = stations(BANK4_OFFSETS, BANK4_KINDS, 512e3, s * seg, N_CALLS,
                      seed=11)
        dstate, jdstate, controls = fb.state.ch.demod, jb.state.ch.demod, \
            bank4_controls
        jextra = ()
    else:
        tb = ChannelizerBank(chan_cfg(ChannelizerBankConfig, ChannelSettings,
                                      tables.Mode), device="cpu")
        fb = ChannelizerBank(chan_cfg(ChannelizerBankConfig, ChannelSettings,
                                      tables.Mode), device="cpu")
        jb = JaxChanBank(chan_cfg(JaxChanConfig, JaxSettings, jtables.Mode))
        seg = tb.design.in_block
        ad = ShardedChannelizerBank(tb, cpu_grid(s, c), graph=graph)
        proc, halo = chanshard.make_channelizer_streaming_processor(
            fb, cpu_grid(s, c), seg)
        jm = jmesh.make_mesh(s, c)
        jproc, jhalo = jchanshard.make_channelizer_streaming_processor(
            jb, jm, seg)
        _, specs = jchanshard.make_channelizer_processor(jb, jm)
        _, _, w_re, w_im = jchanshard.shard_inputs(jb, jm, specs)
        jextra = (w_re, w_im)
        offs = list(tb.cfg.center_freqs_hz() - tb.cfg.fc_hz)
        xs = stations(offs, ["am"] * 5 + ["fm", "am", "usb"], tb.cfg.fs_in,
                      s * seg, N_CALLS, seed=12)
        dstate, jdstate, controls = fb.state.demod, jb.state.demod, \
            chan_controls
    assert halo == jhalo == ad.halo
    n = tb.n_rx
    state = [torch.zeros((halo, 2)), torch.zeros(n, dtype=torch.int64),
             torch.zeros(n, dtype=torch.int64), dstate]
    jstate = [jnp.zeros((halo, 2), jnp.float32), jnp.zeros(n, jnp.int32),
              jnp.zeros(n, jnp.int32), jdstate]
    return dict(ad=ad, proc=proc, state=state, jproc=jproc, jstate=jstate,
                jextra=jextra, jb=jb, fb=fb, xs=xs, controls=controls)


def carried(ad):
    """The adapter's carried tensors in the functional process's order:
    tail, nco_base, bfo_base, then the demod state's leaves."""
    return [ad._tail, ad._nb, ad._bb, *leaves(ad._dstate)]


def run_case(kind, grid, graph=False, jax_too=True):
    """Twelve calls of the adapter, the functional processor and (with
    jax_too) the JAX processor with the controls posted to each bank:
    returns the adapter's audio a call after checking it bit-equal to the
    functional form, audio and carried state, and >= 80 dB a channel
    against JAX's with the bases bit-equal."""
    cs = make_case(kind, grid, graph)
    ad, proc, state = cs["ad"], cs["proc"], cs["state"]
    jstate = cs["jstate"]
    mesh = ad.mesh
    out = []
    for k, x in enumerate(cs["xs"]):
        for b, Mode in ((ad, tables.Mode), (cs["fb"], tables.Mode),
                        (cs["jb"], jtables.Mode)):
            cs["controls"](b, Mode, k)
        xp = jcplx.pack(x)
        pieces = ad.step_device(torch.from_numpy(xp))
        res = proc(torch.from_numpy(xp), cs["fb"].params, *state)
        audio, nb, bb, tail, dst = res[:5]
        state = [tail, nb, bb, dst]
        assert len(pieces) == len(audio) == grid[0] * grid[1]
        for i, (p, q) in enumerate(zip(pieces, audio)):
            assert torch.equal(p, q), (kind, grid, k, i)
        for i, (p, q) in enumerate(zip(carried(ad),
                                       [tail, nb, bb, *leaves(dst)])):
            assert torch.equal(p, q), (kind, grid, k, "carried", i)
        got = ad.audio_from_wire(pieces)
        out.append(got)
        if not jax_too:
            continue
        ja, jnb, jbb, jtail, jdst = cs["jproc"](
            jnp.asarray(xp), cs["jb"].params, *cs["jextra"], *jstate)[:5]
        jstate = [jtail, jnb, jbb, jdst]
        ref = jcplx.unpack(np.asarray(ja))
        assert got.shape == ref.shape == (ad.n_rx, ad.design.out_block)
        for c in range(ad.n_rx):
            s = snr_db(got[c], ref[c])
            assert s >= 80.0, (kind, grid, k, c, s)
        np.testing.assert_array_equal(ad._nb.numpy(), np.asarray(jnb))
        np.testing.assert_array_equal(ad._bb.numpy(), np.asarray(jbb))
    assert mesh.shape == {"stream": grid[0], "ch": grid[1]}
    return ad, out


@pytest.mark.parametrize("grid", BANK_GRIDS)
def test_stream_adapter_body_matches_functional_and_jax(grid):
    """bank4 at 1x1, 2x1, 2x2: the static-buffer body (graph=False) bit
    for bit against the functional processor and >= 80 dB against JAX's
    over twelve super-blocks and the control changes."""
    ad, _ = run_case("bank", grid)
    # the control changes reached the params the shards read
    assert int(ad.params.demod.mode[0]) == int(tables.Mode.AM)
    assert ad.graph_count == 0


@pytest.mark.parametrize("grid", CHAN_GRIDS)
def test_channel_adapter_body_matches_functional_and_jax(grid):
    """chan (8 channels) at 1x4 and 2x2: as the stream adapter's test."""
    ad, _ = run_case("chan", grid)
    assert int(ad.params.demod.mode[5]) == int(tables.Mode.AM)
    assert ad.graph_count == 0


@pytest.mark.parametrize("kind", ["bank", "chan"])
def test_static_inputs_are_views_of_the_carried_tensors(kind):
    """On one device every shard reads views of the bank's params and of
    the adapter's carried state (the head copies only the RF), and the
    carried demod state is the adapter's own, not the wrapped bank's."""
    grid = (2, 2)
    ad = make_case(kind, grid)["ad"]
    ad.prepare(torch.float32, ad.design.in_block)
    assert len(ad._static) == 4
    for sh, st in zip(ad._split.shards, ad._static):
        assert st.loads == []
        assert st.inp.xe.shape == (ad.halo + ad._split.seg, 2)
        assert st.inp.nco_base.data_ptr() == \
            ad._nb[sh.rows].data_ptr()
        assert st.inp.params.nco_k.data_ptr() == \
            ad.params.nco_k[sh.rows].data_ptr()
    bank_state = getattr(ad.bank.state, "ch", ad.bank.state).demod
    assert all(a.data_ptr() != b.data_ptr() for a, b in
               zip(leaves(ad._dstate), leaves(bank_state)))


@pytest.mark.parametrize("what", ["params", "tail", "dstate"])
def test_rebinding_after_prepare_raises(what):
    """The shards read the tensors `prepare` saw: rebinding the bank's
    params or the adapter's carried state raises at the next call, while
    the control verbs (which copy into the params) do not."""
    ad = make_case("bank", (2, 2))["ad"]
    x = torch.zeros((ad.design.in_block, 2))
    ad.step_device(x)
    ad.retune(1, 10.031e6)
    ad.set_mode(0, tables.Mode.USB)
    ad.set_squelch(2, 3.0)
    ad.set_agc(3, False)
    ad.step_device(x)
    if what == "params":
        ad.bank.params = map_tensors(torch.clone, ad.bank.params)
    elif what == "tail":
        ad._tail = ad._tail.clone()
    else:
        ad._dstate = map_tensors(torch.clone, ad._dstate)
    with pytest.raises(RuntimeError, match="rebound"):
        ad.step_device(x)


def test_prepare_takes_only_the_super_block():
    """One set of static buffers whatever the wire (the head dequantizes
    first); a block of another length, or not of pairs, is refused."""
    ad = make_case("bank", (2, 1))["ad"]
    n = ad.design.in_block
    for dtype in (torch.int16, torch.float32, torch.int8):
        ad.prepare(dtype, n)
    first = ad._static
    rng = np.random.default_rng(13)
    x = rng.uniform(-0.5, 0.5, (n, 2)).astype(np.float32)
    for wire in ("f32", "i16", "i8"):
        ad.step_device(torch.from_numpy(cplx.quantize_host(x, wire)))
    assert ad._static is first
    with pytest.raises(ValueError, match="super-blocks"):
        ad.prepare(torch.float32, n // 2)
    with pytest.raises(ValueError, match="pairs"):
        ad.step_device(torch.zeros(n))


# ---- the capture emulated on the CPU ----

class ReplayBody:
    """A stand-in for a CUDA graph on the CPU: its replay runs the body
    a capture would have recorded, over the same static buffers."""

    def __init__(self, run):
        self.run = run

    def replay(self):
        self.run()


# the launches each emulated capture reports for its replays
EMULATED_TALLY = {"linrec": 3, "sr_latch": 1}


@pytest.fixture
def emulated_capture(monkeypatch):
    """graphstep.capture, as the adapters and StepGraphs call it, with
    the warm-up and the outputs of the real one and a graph that replays
    the body eagerly; returns the list of captures made."""
    made = []

    def fake(device, warm_up, body, tensors, stream=None,
             what="the captured tensors"):
        outs = graphstep.empty_like(warm_up())
        cap = graphstep.Captured(
            graph=ReplayBody(lambda: body(outs)),
            launches=dict(EMULATED_TALLY), lookbacks=kscan.Lookbacks(),
            tensors=tensors, bound=tuple(tensors()), what=what)
        made.append((torch.device(device), cap))
        return cap, outs
    monkeypatch.setattr(graphstep, "capture", fake)
    monkeypatch.setattr(adapter_mod, "capture", fake)
    monkeypatch.setattr(torch.cuda, "Stream", lambda *a, **k: None)
    return made


@pytest.mark.parametrize("kind,grid", [("bank", (2, 2)), ("chan", (1, 4))])
def test_adapter_replays_one_graph_a_shard(kind, grid, emulated_capture):
    """With the capture emulated, `prepare` captures one graph a shard on
    the shard's device, every call replays each once (its launches
    counted), and the audio is the graph=False adapter's bit for bit."""
    _, eager = run_case(kind, grid, graph=False, jax_too=False)
    cs = make_case(kind, grid, graph=True)
    ad = cs["ad"]
    ad._graph = True               # the CPU never captures on its own
    ad.prepare(torch.float32, ad.design.in_block)
    n_sh = grid[0] * grid[1]
    assert ad.graph_count == n_sh == len(emulated_capture)
    assert [d for d, _ in emulated_capture] == \
        [sh.device for sh in ad._split.shards]
    kernels.reset_launch_counts()
    for k, x in enumerate(cs["xs"]):
        cs["controls"](ad, tables.Mode, k)
        got = ad.audio_from_wire(ad.step_device(
            torch.from_numpy(jcplx.pack(x))))
        np.testing.assert_array_equal(got, eager[k])
    counts = kernels.launch_counts()
    assert counts["linrec"] == 3 * n_sh * N_CALLS
    assert counts["sr_latch"] == n_sh * N_CALLS
    kernels.reset_launch_counts()
    ad.bank.params = map_tensors(torch.clone, ad.bank.params)
    with pytest.raises(RuntimeError, match="rebound"):
        ad.step_device(torch.zeros((ad.design.in_block, 2)))


def test_step_graphs_capture_through_the_launcher(emulated_capture):
    """StepGraphs captures through graphstep.capture: one graph a (wire
    dtype, in_block), its replays equal to the body's and counted, and a
    rebound state raises at the next replay."""
    cfg = bank4_cfg(config, tables.Mode)
    g = ReceiverBank(cfg, audio_wire="i16", device="cpu")
    e = ReceiverBank(cfg, audio_wire="i16", device="cpu")
    g._graphs.graph = True
    xs = stations(BANK4_OFFSETS, BANK4_KINDS, 512e3, g.design.in_block, 4,
                  seed=14)
    kernels.reset_launch_counts()
    for x in xs:
        xw = torch.from_numpy(cplx.quantize_host(
            x.view(np.float32).reshape(-1, 2), "i16"))
        assert torch.equal(g.step_device(xw), e.step_device(xw))
    assert g.graph_count == 1 and len(emulated_capture) == 1
    assert kernels.launch_counts()["linrec"] == 3 * len(xs)
    kernels.reset_launch_counts()
    g.state = map_tensors(torch.clone, g.state)
    with pytest.raises(RuntimeError, match="rebound"):
        g.step_device(xw)


class BlockSource:
    """Host blocks in order, then the end of the stream."""

    def __init__(self, xs):
        self.xs = list(xs)

    def read_data(self, n, loop=False):
        return self.xs.pop(0) if self.xs else np.zeros(0, np.complex64)


@pytest.mark.parametrize("depth", [1, 2])
def test_executive_over_the_graphed_adapter(depth, emulated_capture):
    """The executive (prefetch on, i16 RF and audio wires) over a 2 x 2
    stream adapter whose shards replay (the capture emulated) drains,
    call after call, the audio of the functional processor on the same
    wire blocks, bit for bit: no piece is overwritten by the next replay
    while it waits in a depth-2 pipeline."""
    cfg = bank4_cfg(config, tables.Mode)
    bank = ReceiverBank(cfg, audio_wire="i16", device="cpu")
    ad = ShardedStreamBank(bank, cpu_grid(2, 2))
    ad._graph = True
    xs = stations(BANK4_OFFSETS, BANK4_KINDS, 512e3, ad.design.in_block, 5,
                  seed=15)
    got = []
    ex = Executive(ad, BlockSource(xs), loop_source=False, wire="i16",
                   pipeline_depth=depth,
                   psd_callback=lambda ex, audio: got.append(audio.copy()))
    ex.run(n_blocks=len(xs))
    ex.stop()
    assert ad.graph_count == 4 and len(got) == len(xs)
    ref = ReceiverBank(cfg, audio_wire="i16", device="cpu")
    proc, halo = stream.make_streaming_processor(
        ref, cpu_grid(2, 2), ref.design.in_block)
    state = [torch.zeros((halo, 2)), torch.zeros(4, dtype=torch.int64),
             torch.zeros(4, dtype=torch.int64), ref.state.ch.demod]
    for k, x in enumerate(xs):
        xw = torch.from_numpy(cplx.quantize_host(
            x.view(np.float32).reshape(-1, 2), "i16"))
        audio, nb, bb, tail, dst, _ = proc(xw, ref.params, *state)
        state = [tail, nb, bb, dst]
        np.testing.assert_array_equal(got[k], ad.audio_from_wire(audio))


def test_baseband_pieces_outlive_the_next_call():
    """With the bank's baseband tap on, each call's baseband pieces are
    copied out of the shards' static outputs: call k's, held as the
    executive holds it, is unchanged after call k+1 and equals the
    functional processor's."""
    cfg = bank4_cfg(config, tables.Mode)
    ad = ShardedStreamBank(ReceiverBank(cfg, emit_baseband=True,
                                        device="cpu"), cpu_grid(2, 2))
    ref = ReceiverBank(cfg, emit_baseband=True, device="cpu")
    proc, halo = stream.make_streaming_processor(
        ref, cpu_grid(2, 2), ref.design.in_block)
    state = [torch.zeros((halo, 2)), torch.zeros(4, dtype=torch.int64),
             torch.zeros(4, dtype=torch.int64), ref.state.ch.demod]
    xs = stations(BANK4_OFFSETS, BANK4_KINDS, 512e3, ad.design.in_block, 3,
                  seed=16)
    held = []
    for x in xs:
        xp = torch.from_numpy(jcplx.pack(x))
        ad.step_device(xp)
        audio, nb, bb, tail, dst, bbs = proc(xp, ref.params, *state)
        state = [tail, nb, bb, dst]
        got = ad.baseband_from_wire(ad._last_bb)
        assert torch.equal(got, ad.baseband_from_wire(bbs))
        held.append((got, got.clone()))
    for k, (bb, snapshot) in enumerate(held):
        assert torch.equal(bb, snapshot), k
    assert not torch.equal(held[0][0], held[1][0])


def test_shards_of_a_grid():
    """mesh.shards: grid order row by row, each shard's global stream
    index, device and channel rows."""
    m = mesh_mod.make_mesh(2, 2, devices=["cpu"] * 4)
    sl = stream.channel_slices(4, m, "receiver")
    got = [(s.index, s.row, s.col, s.stream, s.rows.start, s.rows.stop)
           for s in mesh_mod.shards(m, sl)]
    assert got == [(0, 0, 0, 0, 0, 2), (1, 0, 1, 0, 2, 4),
                   (2, 1, 0, 1, 0, 2), (3, 1, 1, 1, 2, 4)]
