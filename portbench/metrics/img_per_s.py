"""``img_per_s``: images whose logits reached the host inside the window,
over the window's seconds."""


def read(run):
    return run.counter_delta("images") / run.seconds
