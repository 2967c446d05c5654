"""``tokens_per_s``: output tokens of every request resolved inside the
window, over the time from the window's start to the last of those
resolutions (whole rounds: a round still running at the close is not
counted, and neither is its time)."""


def read(run):
    done = [r for r in run.records if not r["error"]]
    if not done:
        return None
    t_last = max(r["t_done"] for r in done)
    return sum(len(r["tokens"]) for r in done) / (t_last - run.t0)
