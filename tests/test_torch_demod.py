"""Parity of the torch port's channel-batched demod against pysdr_tpu's
vmapped demod_block (JAX on the CPU): every one of the ten modes, over a
stream of blocks with the squelch gating and auto-mute tripping, >= 80 dB
audio SNR per block."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pysdr_tpu.ops import cplx as jcplx
from pysdr_tpu.ops import demod as jdemod
from pysdr_tpu.tables import Mode
from pysdr_tpu_torch.ops import demod

torch.set_num_threads(1)

FS = 96e3
N = 3072
MODES = [Mode.AM, Mode.AM_SYNC, Mode.USB, Mode.LSB, Mode.CW, Mode.IQ,
         Mode.WFM, Mode.WFM2, Mode.NFM, Mode.RTTY]
J_DESIGN = jdemod.DemodDesign(fs_out=FS)
T_DESIGN = demod.DemodDesign(fs_out=FS)
# ch0: squelch armed; ch1: auto-mute armed (trips on the loud block)
CHANNELS = (dict(squelch_db=0.0), dict(auto_mute=True, auto_mute_db=-3.0))


def snr_db(got, ref):
    err = (np.abs(got - ref) ** 2).mean()
    return -10 * np.log10(max(err / max((np.abs(ref) ** 2).mean(), 1e-30),
                              1e-30))


def baseband(blk: int, rng) -> np.ndarray:
    """AM envelope on an FM carrier whose modulation holds a 19 kHz
    pilot: every mode's frontend sees real signal. Block 0 is noise only
    (the squelch closes), block 3 is loud (auto-mute trips)."""
    t = (np.arange(N) + blk * N) / FS
    ph = -2000 / 700 * np.cos(2 * np.pi * 700 * t) \
        - 6000 / 19000 * np.cos(2 * np.pi * 19000 * t)
    amp = {0: 0.0, 3: 2.0}.get(blk, 0.3)
    x = amp * (1 + 0.5 * np.cos(2 * np.pi * 300 * t)) * np.exp(2j * np.pi * ph)
    x = x + 0.01 * (rng.standard_normal(N) + 1j * rng.standard_normal(N))
    return x.astype(np.complex64)


def _jax_step():
    carrier = jnp.asarray(J_DESIGN.carrier_filter())
    pilot = jnp.asarray(J_DESIGN.pilot_filter())

    def one(iq, st, p):
        return jdemod.demod_block(iq, st, p, J_DESIGN, carrier, pilot)
    return jax.jit(jax.vmap(one))


J_STEP = _jax_step()


def test_design_filters_and_params_bit_equal():
    np.testing.assert_array_equal(T_DESIGN.carrier_filter(),
                                  J_DESIGN.carrier_filter())
    np.testing.assert_array_equal(T_DESIGN.pilot_filter(),
                                  J_DESIGN.pilot_filter())
    assert T_DESIGN.deemph_alpha() == J_DESIGN.deemph_alpha()
    for mode in MODES:
        for kw in CHANNELS:
            pt = demod.make_params(T_DESIGN, mode, **kw)
            pj = jdemod.make_params(J_DESIGN, mode, **kw)
            np.testing.assert_array_equal(
                pt.af_taps.numpy(), jcplx.unpack(np.asarray(pj.af_taps)))
            for f in ("mode", "bfo_k", "fm_scale", "squelch_lin", "af_gain",
                      "agc_on", "mute_gain", "auto_mute_on",
                      "auto_mute_lin"):
                assert getattr(pt, f).item() == np.asarray(getattr(pj, f)) \
                    .item(), (mode, f)


def test_fft_af_false_is_not_ported():
    d = demod.DemodDesign(fs_out=FS, fft_af=False)
    st = demod.init_state(d, 1)
    p = demod.DemodParams.stack([demod.make_params(d, Mode.AM)])
    taps = torch.from_numpy(d.carrier_filter())
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        demod.demod_block(torch.zeros(1, 64, dtype=torch.complex64), st, p,
                          d, taps, taps)


@pytest.mark.parametrize("mode", MODES, ids=[m.name for m in MODES])
def test_demod_block_matches_jax(mode):
    rng = np.random.default_rng(int(mode))
    pj = [jdemod.make_params(J_DESIGN, mode, **kw) for kw in CHANNELS]
    pj = jax.tree.map(lambda *xs: jnp.stack(xs), *pj)
    sj = jax.tree.map(lambda x: jnp.asarray(np.stack([x, x])),
                      jdemod.init_state(J_DESIGN))
    pt = demod.DemodParams.stack([demod.make_params(T_DESIGN, mode, **kw)
                                  for kw in CHANNELS])
    st = demod.init_state(T_DESIGN, len(CHANNELS))
    carrier = torch.from_numpy(T_DESIGN.carrier_filter())
    pilot = torch.from_numpy(T_DESIGN.pilot_filter())
    gates, muted = [], []
    for blk in range(4):
        iq = np.stack([baseband(blk, rng)] * len(CHANNELS))
        aj, sj = J_STEP(jnp.asarray(iq), sj, pj)
        at, st = demod.demod_block(torch.from_numpy(iq), st, pt, T_DESIGN,
                                   carrier, pilot)
        aj = np.asarray(aj)
        for ch in range(len(CHANNELS)):
            if np.abs(aj[ch]).max() == 0.0:
                # squelched: XLA flushes denormals to zero, torch keeps them
                assert np.abs(at[ch].numpy()).max() < 1e-30, (blk, ch)
            else:
                assert snr_db(at[ch].numpy(), aj[ch]) >= 80.0, (blk, ch)
        np.testing.assert_array_equal(st.sq_gate.numpy(),
                                      np.asarray(sj.sq_gate))
        np.testing.assert_array_equal(st.mute_hold.numpy(),
                                      np.asarray(sj.mute_hold))
        np.testing.assert_array_equal(st.bfo_phase.numpy(),
                                      np.asarray(sj.bfo_phase))
        np.testing.assert_allclose(st.sq_env.numpy(), np.asarray(sj.sq_env),
                                   rtol=1e-4, atol=1e-9)
        gates.append(float(st.sq_gate[0]))
        muted.append(float(st.mute_hold[1]))
    # the stream exercised the features: squelch closed on the noise
    # block, auto-mute tripped on the loud one. (IQ passthrough and the AM
    # envelope, whose noise has a DC term, keep the squelch open.)
    assert gates[0] == 0.0 or mode in (Mode.IQ, Mode.RTTY, Mode.AM), gates
    assert max(muted) > 0.0
