"""latency_p50_ms (ms, host clock): for every block due in the window,
the time its output was delivered (as latency_p95_ms) minus the due time
of its last RF sample; the median (nearest rank) over all of them: how
late the typical block's output comes, which every block's own stages
move. A block that never arrived counts as infinitely late; where that
puts the median out of reach, no value (the run counts it as failed)."""

import math


def read(run):
    if run.due is None:
        return None
    lat = sorted(run.delivered[i] - run.due[i] if i < len(run.delivered)
                 else math.inf for i in run.window_blocks)
    if not lat:
        return None
    p50 = lat[math.ceil(0.5 * len(lat)) - 1]
    return None if math.isinf(p50) else 1e3 * p50
