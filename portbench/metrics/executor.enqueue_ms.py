"""``executor.enqueue_ms``: the mean host time of one call of the bucketed
runner (copy into the bucket's input, the graph's replay, the output's
clone, all enqueued), from the harness's own span around each call in
the window, in ms."""


def read(run):
    calls = run.spans.get("executor.call") or []
    if not calls:
        return None
    return 1e3 * sum(t1 - t0 for t0, t1 in calls) / len(calls)
