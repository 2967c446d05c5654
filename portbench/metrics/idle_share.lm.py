"""The device's idle share over the traced slice: 1 - (the union of every
device operation's interval) / (the slice's length on the host clock),
in %."""


def read(run):
    sl = run.slice
    if sl is None or sl.complete is False or not sl.window_s:
        return None
    return 100.0 * (1.0 - sl.busy_s / sl.window_s)
