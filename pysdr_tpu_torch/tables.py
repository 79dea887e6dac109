"""Static parameter tables: modes, bandwidth menus, supported sample rates.

Functional equivalent of reference Tables.py:34-62 (mode list, AF/VIDEO/PAN
bandwidth menus, RTL/SDRplay rate lists, best-filter picker) re-expressed as
plain data: bandwidths are Hz floats (0.0 == "Max"/passthrough), and every
menu has a parallel pre-designed on-device filter bank (see ops/fir.py) so a
bandwidth change is a bank-index swap, never a recompile — the TPU analogue of
the reference hot-swapping `dec.h` from `dec.filter_bank` (gui.py:1672-1714).

The port's own copy of pysdr_tpu/tables.py, with its imports rewritten to
pysdr_tpu_torch: the port imports nothing of the JAX package.
"""

from __future__ import annotations

import enum


class Mode(enum.IntEnum):
    """Demodulator modes (reference Tables.py:34).

    IntEnum so a per-channel mode id can be a traced int32 dispatched with
    lax.switch inside one compiled channel bank.
    """
    AM = 0
    AM_SYNC = 1    # "AM-Synch" — PLL-based synchronous AM
    USB = 2
    LSB = 3
    CW = 4         # CW: USB with a narrow filter + BFO offset
    IQ = 5         # baseband passthrough (also feeds RTTY)
    WFM = 6        # wideband FM, mono
    WFM2 = 7       # wideband FM, stereo pilot decode
    NFM = 8
    RTTY = 9       # IQ passthrough routed to the RTTY filterbank decoder
    SSB = 2        # alias: "SSB" == USB in the reference menus


MODE_NAMES = {
    Mode.AM: "AM", Mode.AM_SYNC: "AM-Synch", Mode.USB: "USB",
    Mode.LSB: "LSB", Mode.CW: "CW", Mode.IQ: "IQ", Mode.WFM: "WFM",
    Mode.WFM2: "WFM2", Mode.NFM: "NFM", Mode.RTTY: "RTTY",
}


def mode_from_name(name: str) -> Mode:
    """Parse a mode name with the reference's aliasing (gui.py:2042-2078):
    RTTY2/PKTUSB -> IQ, FM -> NFM, SSB -> USB."""
    name = name.upper().replace("-", "_").replace(" ", "")
    aliases = {"AMSYNCH": Mode.AM_SYNC, "AM_SYNCH": Mode.AM_SYNC,
               "SSB": Mode.USB, "FM": Mode.NFM, "RTTY2": Mode.IQ,
               "PKTUSB": Mode.IQ}
    if name in aliases:
        return aliases[name]
    try:
        return Mode[name]
    except KeyError:
        raise ValueError(
            f"unknown mode {name!r}; valid: "
            f"{', '.join(m.name for m in Mode)} (+aliases "
            f"{', '.join(aliases)})") from None


# Bandwidth menus in Hz; 0.0 means "Max" (no extra filtering beyond the
# anti-alias decimation filter). Values mirror reference Tables.py:36-42.
AF_BWS_HZ = [0.0, 50.0, 100.0, 500.0, 1e3, 2e3, 3e3, 4e3, 5e3, 8e3, 10e3,
             15e3, 20e3, 45e3, 50e3, 100e3, 150e3, 200e3]

VIDEO_BWS_HZ = [0.0, 5e3, 10e3, 20e3, 25e3, 45e3, 50e3, 100e3, 150e3, 200e3,
                300e3, 400e3, 500e3, 750e3, 1e6]

PAN_BWS_HZ = [1e3, 3e3, 5e3, 10e3, 20e3, 40e3, 50e3, 100e3, 150e3, 0.0]

# Supported device sample rates in Msps (reference Tables.py:44-45).
RTL_SRATES = [0.25, 1.024, 1.536, 1.792, 1.92, 2.048, 2.16, 2.56, 2.88, 3.2]
SDRPLAY_SRATES = [0.25, 0.5, 1, 2, 2.048, 3, 4, 5, 6, 7, 8, 9, 10]

# Default per-mode audio bandwidth (Hz) used when the user asks for "Max" on
# a narrowband mode; mirrors the de-facto defaults in the reference demod
# chain setup (receiver.py:825-874).
MODE_DEFAULT_AF_BW = {
    Mode.AM: 5e3, Mode.AM_SYNC: 5e3, Mode.USB: 3e3, Mode.LSB: 3e3,
    Mode.CW: 500.0, Mode.IQ: 0.0, Mode.WFM: 15e3, Mode.WFM2: 15e3,
    Mode.NFM: 5e3, Mode.RTTY: 1e3,
}

# CW beat-frequency offset (Hz) — the reference constructs a standalone BFO
# `dsp.signal_generator(bfo, ...)` (receiver.py:822).
CW_BFO_HZ = 700.0

# WFM constants: deviation 75 kHz, pilot 19 kHz, de-emphasis 75 us (US).
WFM_DEVIATION_HZ = 75e3
WFM_PILOT_HZ = 19e3
WFM_DEEMPHASIS_S = 75e-6
NFM_DEVIATION_HZ = 5e3

MAX_RX = 6  # reference clamp (params.py:33,271-277); our bank is arbitrary-N,
            # this constant only gates the reference-compatible CLI surface.


def find_filter(max_bw_hz: float, bw_list_hz) -> float:
    """Best (largest) bandwidth in the menu that is <= max_bw_hz.

    Equivalent of reference Tables.py:48-62 `find_filter`, on Hz floats.
    Returns 0.0 ("Max") only if no finite entry fits.
    """
    best = 0.0
    for bw in bw_list_hz:
        if bw > 0.0 and bw <= max_bw_hz:
            best = max(best, bw)
    return best


def find_filter_index(max_bw_hz: float, bw_list_hz) -> int:
    """Index variant of find_filter, for filter-bank selection."""
    best_i, best = 0, 0.0
    for i, bw in enumerate(bw_list_hz):
        if bw > 0.0 and best < bw <= max_bw_hz:
            best_i, best = i, bw
    return best_i


# Broadcast station presets (callsign -> (freq_kHz_or_MHz, mode)) — the
# reference ships a preset list (Tables.py:66-136) read by the GUI; kept
# small here, extensible via io/presets.
STATIONS = {
    "KOGO": (600e3, Mode.AM),
    "KFMB": (760e3, Mode.AM),
    "WWV5": (5e6, Mode.AM),
    "WWV10": (10e6, Mode.AM),
    "WWV15": (15e6, Mode.AM),
}
