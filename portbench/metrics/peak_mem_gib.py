"""``peak_mem_gib``: ``torch.cuda.max_memory_allocated()`` over the whole
run (set-up and window), read from the card's allocator before the check
runs, in GiB."""


def read(run):
    if run.memory_peak_bytes is None:
        return None
    return run.memory_peak_bytes / 2 ** 30
