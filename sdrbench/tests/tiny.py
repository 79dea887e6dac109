"""Cells at sizes a CPU test run holds: the bank4 and chan64 chains with
fewer samples a second (1.92 MHz, 8 channels at 1.536 MHz), the same
modes, squelch and wires."""

from __future__ import annotations

from sdrbench import harness

BANK = {
    "argv": ["--fs", "1.92", "--fc", "100.0", "100.2", "100.4", "100.6",
             "--modes", "AM", "NFM", "USB", "CW"],
    "scene": {"samples": 600000, "fs": 1920000.0, "fc": 100.3e6,
              "noise_rms": 0.02, "level": [0.05, 0.1],
              "stations": [{"kind": "am", "offset_hz": -300e3},
                           {"kind": "nfm", "offset_hz": -100e3},
                           {"kind": "usb", "offset_hz": 100e3},
                           {"kind": "cw", "offset_hz": 300e3}]},
    "reference": {"kind": "receivers",
                  "fc_mhz": [100.0, 100.2, 100.4, 100.6],
                  "modes": ["AM", "NFM", "USB", "CW"], "fs_in": 1920000.0,
                  "fs_out": 48000.0}}
CHAN = {
    "argv": ["--channelize", "8", "--fs", "1.536", "--fc", "100.0",
             "--mode", "AM", "--squelch", "10"],
    "scene": {"samples": 500000, "fs": 1.536e6, "fc": 100e6,
              "noise_rms": 0.03, "level": [0.02, 0.04],
              "channel_stations": {"n_channels": 8, "share": 0.5,
                                   "kind": "am"}},
    "reference": {"kind": "channels", "fs_in": 1.536e6, "n_channels": 8,
                  "mode": "AM", "fs_out": 48000.0, "squelch_db": 10.0}}


def traffic(loop="closed", capture="complex64", wire="f32",
            audio_wire="f32", rate=0.5):
    return {"capture": capture, "wire": wire, "audio_wire": audio_wire,
            "block": 1024, "pipeline_depth": 2, "prefetch": True,
            "loop": loop, "rate": rate, "warm_blocks": 4,
            "compare_blocks": 3, "trace_blocks": 4}


# the limits a bank4 CS8 replay with i16 audio held on the chip (the
# program's share of differing codes <= 0.012, the TF32 control's
# >= 0.58; PERF.md)
I16_CHECKS = {"audio_code_mismatch": 0.12, "latch_unsettled": 0}


def bank_cell(**kw) -> harness.Cell:
    """bank4's chain under bank4.live_1x's limits (f32 audio) or those of
    a bank4 replay with i16 audio."""
    tr = traffic(**kw)
    checks = harness.cell("bank4.live_1x").checks \
        if tr["audio_wire"] == "f32" else I16_CHECKS
    return harness.Cell("tiny.bank", BANK, tr, dict(checks))


def chan_cell(loop="closed") -> harness.Cell:
    """chan64's chain under chan64.live_1x's wires and limits."""
    return harness.Cell("tiny.chan", CHAN,
                        traffic(loop, capture="cs8", wire="i8",
                                audio_wire="i8"),
                        dict(harness.cell("chan64.live_1x").checks))
