"""``service.batch_mean``: requests per micro-batch the serving front end
formed over the window (its ``completed`` over its ``batches``
counters)."""


def read(run):
    batches = run.counter_delta("batches")
    return run.counter_delta("completed") / batches if batches else None
