"""``engine.slot_occupancy``: the share of the continuous engine's arena
rows that held a request, over its decode steps in the window (its
occupied-slot-steps and decode-steps counters), in %."""


def read(run):
    steps = run.counter_delta("decode_steps")
    if not steps:
        return None
    slots = run.counters["after"]["batch_slots"]
    return 100.0 * run.counter_delta("slot_steps") / (steps * slots)
