"""Station presets.

Equivalent of the reference's `presets.xls` workbook reading
(reference gui.py:419-435 read_presets2/make_ham_presets2; hopper 'Hops'
sheet hopper.py:74-88). The reference depends on xlrd + a binary
spreadsheet; here presets are JSON or CSV (self-describing, diffable):

  JSON: {"presets": [{"name": "WWV10", "freq_hz": 10e6, "mode": "AM",
                      "group": "Time"}...],
         "hops": {"6": ["20m:FT8", ...], ...}}
  CSV rows: name,freq_hz,mode[,group]

The port's own copy of pysdr_tpu/runtime/presets.py, with its imports
rewritten to pysdr_tpu_torch: the port imports nothing of the JAX package.
"""

from __future__ import annotations

import csv
import dataclasses
import json

from pysdr_tpu_torch import tables


@dataclasses.dataclass(frozen=True)
class Preset:
    name: str
    freq_hz: float
    mode: tables.Mode
    group: str = ""


def builtin_presets() -> list[Preset]:
    """Built-in broadcast/time stations (reference Tables.py:66-136)."""
    return [Preset(name=n, freq_hz=f, mode=m, group="builtin")
            for n, (f, m) in tables.STATIONS.items()]


def load_json(path: str) -> tuple[list[Preset], dict[int, list]]:
    with open(path) as f:
        data = json.load(f)
    presets = [Preset(name=p["name"], freq_hz=float(p["freq_hz"]),
                      mode=tables.mode_from_name(p.get("mode", "AM")),
                      group=p.get("group", ""))
               for p in data.get("presets", [])]
    hops = {int(h): l for h, l in data.get("hops", {}).items()}
    return presets, hops


def load_csv(path: str) -> list[Preset]:
    out = []
    with open(path) as f:
        for row in csv.reader(f):
            if not row or row[0].startswith("#"):
                continue
            out.append(Preset(
                name=row[0], freq_hz=float(row[1]),
                mode=tables.mode_from_name(row[2] if len(row) > 2 else "AM"),
                group=row[3] if len(row) > 3 else ""))
    return out


def load(path: str | None):
    """Load presets from a file (json/csv) plus the builtins."""
    presets = builtin_presets()
    hops: dict[int, list] = {}
    if path:
        if path.endswith(".json"):
            p, hops = load_json(path)
            presets += p
        else:
            presets += load_csv(path)
    return presets, hops


def groups(presets) -> dict[str, list[Preset]]:
    """Group presets into tabs (the reference's per-sheet preset tabs)."""
    out: dict[str, list[Preset]] = {}
    for p in presets:
        out.setdefault(p.group or "misc", []).append(p)
    return out
