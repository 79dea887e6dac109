"""Offline watchdog-log analyzer: `python -m pysdr_tpu_torch.latency LOG.csv`.

Equivalent of the reference's Octave latency analysis of its /tmp/LOG
files (reference sigs/plot_latency.m:1-97, fed by watchdog.py:176-227):
summarizes the per-ring audio latency the watchdog sampled every 2 s —
p50/p95/min/max latency, the EMA trend, and every self-heal event (drops
on high-water, zero-fills on low-water) the log recorded.

Log format (runtime/watchdog.py, which `--watchdog-log` writes): sample
lines
    tag,unix_time,nsamps,latency_s,latency_ema_s
and event lines
    #HIGH,tag,unix_time,n_dropped      /      #LOW,tag,unix_time,n_zeroed

The port's own copy of pysdr_tpu/latency.py (only its usage line names
this package): the port imports nothing of the JAX package.
"""

from __future__ import annotations

import sys


def percentile(sorted_vals, q: float) -> float:
    """Nearest-rank percentile on an already-sorted list."""
    if not sorted_vals:
        return 0.0
    i = min(len(sorted_vals) - 1, max(0, round(q * (len(sorted_vals) - 1))))
    return sorted_vals[i]


def analyze(path: str) -> dict:
    """Parse one watchdog CSV -> {tag: summary dict}."""
    samples: dict[str, list] = {}
    events: dict[str, dict] = {}
    with open(path) as f:
        for raw in f:
            line = raw.strip()
            if not line:
                continue
            if line.startswith("#"):
                kind, tag, t, n = line[1:].split(",")
                ev = events.setdefault(tag, {"drops": 0, "dropped_samples": 0,
                                             "zero_fills": 0,
                                             "zeroed_samples": 0})
                if kind == "HIGH":
                    ev["drops"] += 1
                    ev["dropped_samples"] += int(n)
                else:
                    ev["zero_fills"] += 1
                    ev["zeroed_samples"] += int(n)
                continue
            tag, t, nsamps, lat, ema = line.split(",")
            samples.setdefault(tag, []).append(
                (float(t), int(nsamps), float(lat), float(ema)))
    out = {}
    for tag, rows in samples.items():
        lats = sorted(r[2] for r in rows)
        ev = events.get(tag, {"drops": 0, "dropped_samples": 0,
                              "zero_fills": 0, "zeroed_samples": 0})
        out[tag] = {
            "n_samples": len(rows),
            "span_s": round(rows[-1][0] - rows[0][0], 1) if len(rows) > 1
            else 0.0,
            "latency_p50_s": round(percentile(lats, 0.50), 4),
            "latency_p95_s": round(percentile(lats, 0.95), 4),
            "latency_min_s": round(lats[0], 4),
            "latency_max_s": round(lats[-1], 4),
            "latency_ema_last_s": round(rows[-1][3], 4),
            **ev,
        }
    # events for tags that never produced a sample line still matter
    for tag, ev in events.items():
        out.setdefault(tag, {"n_samples": 0, "span_s": 0.0, **ev})
    return out


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        print("usage: python -m pysdr_tpu_torch.latency LOG.csv "
              "[LOG2.csv ...]", file=sys.stderr)
        return 2
    rc = 0
    for path in argv:
        try:
            summary = analyze(path)
        except (OSError, ValueError) as e:
            print(f"{path}: {e}", file=sys.stderr)
            rc = 1
            continue
        print(f"== {path}")
        if not summary:
            print("  (empty log)")
        for tag, s in summary.items():
            print(f"  {tag}: n={s['n_samples']} span={s['span_s']}s "
                  f"latency p50={s.get('latency_p50_s', 0)}s "
                  f"p95={s.get('latency_p95_s', 0)}s "
                  f"min={s.get('latency_min_s', 0)}s "
                  f"max={s.get('latency_max_s', 0)}s")
            print(f"      self-heals: {s['drops']} drops "
                  f"({s['dropped_samples']} samples), "
                  f"{s['zero_fills']} zero-fills "
                  f"({s['zeroed_samples']} samples)")
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
