"""The banks' step over static buffers (models/graphstep), the body a CUDA
graph captures and replays, on the CPU, where the same body runs as it
is: twelve blocks of numpy-seeded stations against the JAX banks at
>= 80 dB per channel with retune, set_mode (AM -> NFM -> USB),
set_squelch and set_agc posted between blocks to both; block k's
baseband intact after block k+1's step; the executive at depths 1-3 bit
for bit against the functional `_step_impl`; and the bookkeeping a
replay relies on (control verbs write into the captured tensors, the
look-back buffers a capture names, the launches a replay adds).

The graph itself, its replays past the scans' epoch wrap and the launch
counts through them run on the card: tests/test_torch_kernels.py."""

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
from pysdr_tpu_torch import config, kernels, tables
from pysdr_tpu_torch.device import leaves, map_tensors
from pysdr_tpu_torch.kernels import build
from pysdr_tpu_torch.kernels import scan as kscan
from pysdr_tpu_torch.models import graphstep
from pysdr_tpu_torch.models.channelizer_bank import (ChannelizerBank,
                                                     ChannelizerBankConfig,
                                                     ChannelSettings)
from pysdr_tpu_torch.models.receiver import ReceiverBank
from pysdr_tpu_torch.ops import cplx
from pysdr_tpu_torch.runtime.executive import Executive

torch.set_num_threads(1)

N_BLOCKS = 12
N_CH = 8
# bank4_cfg's stations: each RX's offset from the passband's center (its
# dial less the center's 9.94 MHz) and what it sends
BANK4_OFFSETS = [60e3, 90e3, 30e3, 120e3]
BANK4_KINDS = ["am", "fm", "usb", "am"]


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


def bank4_controls(b, Mode, blk):
    """The control changes posted before block blk of the bank4 run."""
    if blk == 3:
        b.retune(1, 10.031e6)
        b.set_mode(0, Mode.NFM)
    elif blk == 5:
        b.set_mode(0, Mode.USB)
        b.set_squelch(2, 3.0)
    elif blk == 7:
        b.set_agc(3, False)
        b.retune(2, 9.971e6)
    elif blk == 9:
        b.set_mode(0, Mode.AM)
        b.set_agc(3, True)
        b.set_squelch(2, -150.0)


def chan_controls(b, Mode, blk):
    """The control changes posted before block blk of the channel run."""
    if blk == 3:
        b.retune(2, 4e3)
        b.set_mode(5, Mode.NFM)
    elif blk == 5:
        b.set_mode(5, Mode.USB)
        b.set_squelch(1, 3.0)
    elif blk == 7:
        b.set_agc(6, False)
        b.retune(2, 0.0)
    elif blk == 9:
        b.set_mode(5, Mode.AM)
        b.set_agc(6, True)


def make_pair(kind):
    """(port bank on the CPU, JAX bank, host blocks, control function)."""
    if kind == "bank4":
        tb = ReceiverBank(bank4_cfg(config, tables.Mode), device="cpu")
        jb = JaxBank(bank4_cfg(jconfig, jtables.Mode))
        xs = stations(BANK4_OFFSETS, BANK4_KINDS, 512e3,
                      tb.design.in_block, N_BLOCKS, seed=1)
        return tb, jb, xs, bank4_controls
    tb = ChannelizerBank(chan_cfg(ChannelizerBankConfig, ChannelSettings,
                                  tables.Mode), device="cpu")
    jb = JaxChanBank(chan_cfg(JaxChanConfig, JaxSettings, jtables.Mode))
    cfg = tb.cfg
    offs = cfg.center_freqs_hz() - cfg.fc_hz
    xs = stations(list(offs), ["am", "am", "am", "am", "am", "fm", "am",
                               "usb"], cfg.fs_in, tb.design.in_block,
                  N_BLOCKS, seed=2)
    return tb, jb, xs, chan_controls


@pytest.mark.parametrize("kind", ["bank4", "chan64"])
def test_body_matches_jax_over_control_changes(kind):
    """Twelve blocks through the static-buffer body against the JAX bank,
    the same control changes posted to both between blocks: >= 80 dB a
    channel every block, and the step keeps writing into the state and
    params tensors it started with (what a captured graph reads)."""
    tb, jb, xs, controls = make_pair(kind)
    state_ptrs = [t.data_ptr() for t in leaves(tb.state)]
    params = tb.params
    param_ptrs = [t.data_ptr() for t in leaves(params)]
    for blk, x in enumerate(xs):
        for b, Mode in ((tb, tables.Mode), (jb, jtables.Mode)):
            controls(b, Mode, blk)
        a_t, a_j = tb.step(x), np.asarray(jb.step(x))
        assert a_t.shape == a_j.shape == (tb.n_rx, tb.design.out_block)
        for c in range(tb.n_rx):
            s = snr_db(a_t[c], a_j[c])
            assert s >= 80.0, (kind, blk, c, s)
    assert [t.data_ptr() for t in leaves(tb.state)] == state_ptrs
    assert tb.params is params
    assert [t.data_ptr() for t in leaves(tb.params)] == param_ptrs
    # the control changes reached the params the step reads
    assert int(tb.params.demod.mode[0 if kind == "bank4" else 5]) == \
        int(tables.Mode.AM)
    assert tb.graph_count == 0          # the CPU runs the body as it is


def test_baseband_of_block_k_survives_step_k_plus_1():
    """With emit_baseband the step's baseband is copied out of its static
    output: block k's, held as the executive holds it, is unchanged after
    block k+1's step, and equals the functional step's for block k."""
    bank = ReceiverBank(bank4_cfg(config, tables.Mode), emit_baseband=True,
                        device="cpu")
    ref = ReceiverBank(bank4_cfg(config, tables.Mode), emit_baseband=True,
                       device="cpu")
    state = ref.init_state()
    xs = stations(BANK4_OFFSETS, BANK4_KINDS, 512e3, bank.design.in_block,
                  4, seed=3)
    held = []
    for x in xs:
        xb = bank.to_device_block(x)
        bank.step_device(xb)
        held.append((bank._last_bb, bank._last_bb.clone()))
        state, (_, bb_ref) = ref._step_impl(state, xb, ref.params)
        assert torch.equal(bank._last_bb, bb_ref)
    for k, (bb, snapshot) in enumerate(held):
        assert torch.equal(bb, snapshot), k
    assert not torch.equal(held[0][0], held[1][0])


class BlockSource:
    """Host blocks in order, then the end of the stream."""

    def __init__(self, xs):
        self.xs = list(xs)

    def read_data(self, n, loop=False):
        return self.xs.pop(0) if self.xs else np.zeros(0, np.complex64)


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_executive_matches_the_functional_step(depth):
    """The executive over the static-buffer step (prefetch thread on, i16
    RF and audio wires) drains, block after block, the audio of the
    functional `_step_impl` driven by hand on the same wire blocks, bit
    for bit: no block's audio is overwritten by a later step while it
    waits in the pipeline."""
    cfg = bank4_cfg(config, tables.Mode)
    bank = ReceiverBank(cfg, audio_wire="i16", device="cpu")
    xs = stations(BANK4_OFFSETS, BANK4_KINDS, 512e3, bank.design.in_block,
                  7, seed=4)
    got = []
    ex = Executive(bank, BlockSource(xs), loop_source=False, wire="i16",
                   pipeline_depth=depth,
                   psd_callback=lambda ex, audio: got.append(audio.copy()))
    ex.run(n_blocks=len(xs))
    ex.stop()
    ref = ReceiverBank(cfg, audio_wire="i16", device="cpu")
    state = ref.init_state()
    assert len(got) == len(xs)
    for k, x in enumerate(xs):
        pairs = x.view(np.float32).reshape(-1, 2)
        xw = torch.from_numpy(cplx.quantize_host(pairs, "i16"))
        state, (out, _) = ref._step_impl(state, xw, ref.params)
        np.testing.assert_array_equal(got[k], ref.audio_from_wire(out))


def test_control_verbs_write_into_the_captured_params():
    """Every control verb leaves the bank holding the tensors a capture
    took (StepGraphs.check passes); rebinding the params fails it."""
    for bank in (ReceiverBank(bank4_cfg(config, tables.Mode), device="cpu"),
                 ChannelizerBank(chan_cfg(ChannelizerBankConfig,
                                          ChannelSettings, tables.Mode),
                                 device="cpu")):
        g = bank._graphs
        st = graphstep._Step(x=torch.zeros(0), outs=(), bound=g._tensors())
        M = tables.Mode
        for verb, args in (("retune", (1, bank.cfg.fc_hz + 1e3)
                            if isinstance(bank, ChannelizerBank)
                            else (1, 10.031e6)),
                           ("set_mode", (0, M.USB)),
                           ("set_video_bw", (1, 5e3)),
                           ("set_af_bw", (0, 2.5e3)),
                           ("set_af_gain", (0, 0.5)),
                           ("set_squelch", (2, 3.0)),
                           ("set_agc", (3, False)),
                           ("set_mute", (1, True))):
            getattr(bank, verb)(*args)
            g.check(st)
        if isinstance(bank, ReceiverBank):
            bank.set_auto_mute(0, True, -20.0)
            bank.set_auto_mute_all(False)
            g.check(st)
        bank.params = map_tensors(torch.clone, bank.params)
        with pytest.raises(RuntimeError, match="rebound"):
            g.check(st)


def test_step_keys_and_the_graph_flag():
    """One set of static buffers a (wire dtype, in_block), made at the
    first block of each; on the CPU no graph, whatever `graph` says; a
    block that is not (n, 2) pairs is refused."""
    cfg = bank4_cfg(config, tables.Mode)
    for graph in (True, False):
        bank = ReceiverBank(cfg, device="cpu", graph=graph)
        assert not bank._graphs.graph
        n = bank.design.in_block
        rng = np.random.default_rng(5)
        x = rng.uniform(-0.5, 0.5, (n, 2)).astype(np.float32)
        for wire in ("f32", "i16", "i8", "i16"):
            bank.step_device(torch.from_numpy(cplx.quantize_host(x, wire)))
        assert set(bank._graphs._steps) == {
            (torch.float32, n), (torch.int16, n), (torch.int8, n)}
        assert bank.graph_count == 0
        with pytest.raises(ValueError, match="pairs"):
            bank.step_device(torch.zeros(n))


def test_mesh_adapter_prepares_nothing():
    """The executive's prepare on an adapter makes the adapter's own
    static buffers (one set a shard, parallel/adapter.py), none in the
    wrapped bank, whose step never runs."""
    from pysdr_tpu_torch.parallel import mesh as mesh_mod
    from pysdr_tpu_torch.parallel.adapter import ShardedStreamBank
    bank = ReceiverBank(bank4_cfg(config, tables.Mode), device="cpu")
    ad = ShardedStreamBank(bank, mesh_mod.make_mesh(
        1, 1, devices=[torch.device("cpu")]))
    ad.prepare(torch.int16, ad.design.in_block)
    assert bank._graphs._steps == {}


def test_lookback_scope_names_the_buffers():
    """Inside lookback_scope the scans take the scope's buffers, kind by
    kind, made once and kept; a set is bound to one device."""
    lbs = kscan.Lookbacks()
    cpu = torch.device("cpu")
    with kscan.lookback_scope(lbs):
        lr = kscan._lookback("linrec", cpu)
        lt = kscan._lookback("sr_latch", cpu)
        assert kscan._lookback("linrec", cpu) is lr
    assert lr is not lt and lr.dtype == torch.int64 and \
        lt.dtype == torch.uint8
    assert (lr.max_epoch, lt.max_epoch) == ((1 << 30) - 1, 31)
    with pytest.raises(ValueError, match="look-back buffers"):
        lbs.get("linrec", torch.device("meta"))


def test_capture_tally_and_replay_counts():
    """Launches made while a capture's tally is open go to the tally, not
    the counts; each replay adds the tally to the counts."""
    kernels.reset_launch_counts()
    with build.capture_tally() as tally:
        build.count_launch(kscan.linrec)
        build.count_launch(kscan.linrec)
        build.count_launch(kscan.sr_latch)
    assert tally == {"linrec": 2, "sr_latch": 1}
    assert kernels.launch_counts()["linrec"] == 0
    build.count_launch(kscan.linrec)
    for _ in range(3):
        kernels.add_launches(tally)
    assert kernels.launch_counts() == {"linrec": 7, "sr_latch": 3,
                                       "pfb_branch": 0, "rtty_scores": 0}
    kernels.reset_launch_counts()
