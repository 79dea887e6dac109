"""latency_p95_ms (ms, host clock; read per layer as latency_p95_ms.live,
the host's stalls setting the tail): for every block due in the window,
the time its output was delivered (its audio at the audio rings and,
where the App runs per-block taps such as --rtty, their output) minus
the due time of its last RF sample; the 95th percentile (nearest rank)
over all of them. A block that never arrived reads as missing every
limit (no value; the run counts it as failed)."""

import math


def read(run):
    if run.due is None:
        return None
    lat = sorted(run.delivered[i] - run.due[i] if i < len(run.delivered)
                 else math.inf for i in run.window_blocks)
    if not lat:
        return None
    p95 = lat[math.ceil(0.95 * len(lat)) - 1]
    return None if math.isinf(p95) else 1e3 * p95
