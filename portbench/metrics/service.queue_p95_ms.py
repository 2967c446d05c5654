"""``service.queue_p95_ms``: the 95th percentile (nearest rank) of the
serving front end's ``queue`` spans (submit → its micro-batch taken,
``serving/service.py``'s tracer) that began and ended inside the window,
in ms."""

import math


def read(run):
    spans = run.spans.get("service.queue") or []
    if not spans:
        return None
    lat = sorted(t1 - t0 for t0, t1 in spans)
    return lat[math.ceil(0.95 * len(lat)) - 1] * 1e3
