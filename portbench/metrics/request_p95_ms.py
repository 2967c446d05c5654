"""``request_p95_ms``: the 95th percentile (nearest rank) over every
request resolved inside the window of submit → future resolved, on the
harness's clock. A failed request counts as missing every limit."""

import math


def read(run):
    if not run.records:
        return None
    lat = sorted(math.inf if r["error"] else r["t_done"] - r["t_submit"]
                 for r in run.records)
    return lat[math.ceil(0.95 * len(lat)) - 1] * 1e3
