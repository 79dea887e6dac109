"""Scheduled frequency hopping / band scanning.

Equivalent of the reference `FreqHopper` (reference hopper.py:51-199): hops
a receiver through a list of (freq, mode) entries on a timer; hop lists
come from the CLI or from the presets 'Hops' schedule keyed by hour
(hopper.py:74-111); FT8/FT4 lists are expanded from the band table
(hopper.py:140-147); hops align to the WSJT 15-second cycle
(hopper.py:187-199). Qt timers become a plain daemon-thread scheduler
posting block-boundary commands to the executive.

The port's own copy of pysdr_tpu/runtime/hopper.py, with its imports
rewritten to pysdr_tpu_torch: the port imports nothing of the JAX package.
"""

from __future__ import annotations

import threading
import time

from pysdr_tpu_torch import tables

# Per-band digital-mode frequencies (kHz) — the subset of the reference's
# `rig_io.bands` table used for hopping (reference params.py:24,
# hopper.py:163-169).
BANDS_KHZ = {
    # WSJT-X defines no 160m FT4 slot; use the 1840 digital window (the
    # old '1050 + 800' literal landed hops in the SSB segment)
    "160m": {"FT8": 1840, "FT4": 1840, "CW1": 1810, "CW2": 1840},
    "80m": {"FT8": 3573, "FT4": 3575.5, "CW1": 3510, "CW2": 3560},
    "40m": {"FT8": 7074, "FT4": 7047.5, "CW1": 7010, "CW2": 7060},
    "30m": {"FT8": 10136, "FT4": 10140, "CW1": 10110, "CW2": 10120},
    "20m": {"FT8": 14074, "FT4": 14080, "CW1": 14010, "CW2": 14060},
    "17m": {"FT8": 18100, "FT4": 18104, "CW1": 18070, "CW2": 18080},
    "15m": {"FT8": 21074, "FT4": 21140, "CW1": 21010, "CW2": 21060},
    "12m": {"FT8": 24915, "FT4": 24919, "CW1": 24895, "CW2": 24905},
    "10m": {"FT8": 28074, "FT4": 28180, "CW1": 28010, "CW2": 28060},
    "6m": {"FT8": 50313, "FT4": 50318, "CW1": 50090, "CW2": 50100},
}


def freq2band(freq_hz: float) -> str:
    """Band name for a frequency (reference utilities.freq2band)."""
    mhz = freq_hz / 1e6
    edges = [("160m", 1.8, 2.0), ("80m", 3.5, 4.0), ("40m", 7.0, 7.3),
             ("30m", 10.1, 10.15), ("20m", 14.0, 14.35),
             ("17m", 18.068, 18.168), ("15m", 21.0, 21.45),
             ("12m", 24.89, 24.99), ("10m", 28.0, 29.7),
             ("6m", 50.0, 54.0)]
    for name, lo, hi in edges:
        if lo <= mhz <= hi:
            return name
    return "?"


def expand_hop_list(entries) -> list[tuple[float, tables.Mode]]:
    """Expand symbolic entries: "FT8" -> every band's FT8 freq (the
    reference's FT8/FT4 multi-band expansion, params.py:254-267,
    hopper.py:140-147); "<band>:<slot>" -> that band's slot; a number ->
    (hz, IQ)."""
    out = []
    for e in entries:
        if isinstance(e, (int, float)):
            out.append((float(e), tables.Mode.IQ))
        elif isinstance(e, tuple):
            out.append((float(e[0]), tables.mode_from_name(str(e[1]))))
        elif e in ("FT8", "FT4"):
            for band in BANDS_KHZ.values():
                out.append((band[e] * 1e3, tables.Mode.IQ))
        elif ":" in e:
            band, slot = e.split(":")
            out.append((BANDS_KHZ[band][slot] * 1e3,
                        tables.Mode.CW if slot.startswith("CW")
                        else tables.Mode.IQ))
        else:
            raise ValueError(e)
    return out


def load_hop_schedule(path: str) -> dict[int, list]:
    """Hour-keyed hop schedule file -> {hour: hop_list} for FreqHopper
    (the reference's presets 'Hops' sheet keyed by hour,
    hopper.py:74-111). Format: one rule per line,

        HOUR[-HOUR]: entry [entry ...]      # comments allowed

    where each entry is anything expand_hop_list accepts — a frequency
    in MHz (e.g. 7.074), a symbolic slot ("40m:FT8", "20m:CW1"), or the
    multi-band expanders "FT8"/"FT4". Hours are local, 0-23; a range
    covers both endpoints. Example:

        0-5:   80m:FT8 160m:FT8     # gray-line lows overnight
        6-17:  FT8                  # all bands through the day
        18-23: 40m:FT8 40m:CW1
    """
    sched: dict[int, list] = {}
    with open(path) as f:
        for ln, raw in enumerate(f, 1):
            line = raw.split("#")[0].strip()
            if not line:
                continue
            hours, _, rest = line.partition(":")
            entries = []
            for tok in rest.split():
                try:
                    entries.append(float(tok) * 1e6)   # MHz
                except ValueError:
                    entries.append(tok)
            lo, _, hi = hours.strip().partition("-")
            try:
                h0, h1 = int(lo), int(hi or lo)
            except ValueError as e:
                raise ValueError(f"{path}:{ln}: bad hour spec "
                                 f"{hours!r}") from e
            if not (0 <= h0 <= 23 and 0 <= h1 <= 23):
                raise ValueError(f"{path}:{ln}: hour out of range")
            # '22-6' wraps midnight (overnight schedules are the most
            # natural use of an hour-keyed hop plan)
            hours = range(h0, h1 + 1) if h0 <= h1 else \
                [*range(h0, 24), *range(0, h1 + 1)]
            for h in hours:
                sched[h] = entries
    return sched


class FreqHopper:
    """Timer-driven hopper posting retunes to the executive."""

    def __init__(self, executive, hop_list, dwell_s: float = 15.0,
                 rx_index: int = 0, align_wsjt: bool = False,
                 schedule: dict[int, list] | None = None):
        """hop_list: entries for expand_hop_list. schedule: optional
        {hour: hop_list} like the presets 'Hops' sheet keyed by hour
        (reference hopper.py:74-111)."""
        self.ex = executive
        self.hops = expand_hop_list(hop_list)
        self.schedule = {h: expand_hop_list(l)
                         for h, l in (schedule or {}).items()}
        self.dwell_s = dwell_s
        self.rx_index = rx_index
        self.align_wsjt = align_wsjt
        self.idx = 0
        self.n_hops = 0
        self._stop = threading.Event()
        self._thread = None

    def current_hops(self):
        if self.schedule:
            hour = time.localtime().tm_hour
            if hour in self.schedule:
                return self.schedule[hour]
        return self.hops

    def hop_once(self):
        hops = self.current_hops()
        if not hops:
            return None
        freq, mode = hops[self.idx % len(hops)]
        self.idx += 1
        self.n_hops += 1
        self.ex.post("retune", self.rx_index, freq)
        self.ex.post("set_mode", self.rx_index, mode)
        return freq, mode

    def _sleep_until_next(self):
        if self.align_wsjt:
            # align to the WSJT-X 15 s cycle (reference hopper.py:187-199)
            now = time.time()
            nxt = (now // 15.0 + 1) * 15.0
            self._stop.wait(max(0.0, nxt - now))
        else:
            self._stop.wait(self.dwell_s)

    def start(self):
        def loop():
            while not self._stop.is_set():
                self.hop_once()
                self._sleep_until_next()
        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
