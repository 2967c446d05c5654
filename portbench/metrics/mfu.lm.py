"""``mfu.lm``: the logical work of every request resolved inside the
window (its prompt's prefill and each later token's decode position, each
at its true context: ``portbench/work/lm.py``) over the same time as
``tokens_per_s``, as a share of one H100's dense int8 peak, in %.

It is read in the traced run, so it counts only the rounds before the
traced one: neither the profiler's recording nor the end of it stretches
the time it divides by."""

from portbench.work import lm, peaks


def read(run):
    last = getattr(run, "traced_round", None)
    done = [r for r in run.records if not r["error"]
            and (last is None or r["round"] < last)]
    if not done:
        return None
    t_last = max(r["t_done"] for r in done)
    work = sum(lm.request_flops(run.config, r["prompt"], len(r["tokens"]))
               for r in done)
    return 100.0 * work / (t_last - run.t0) / peaks.INT8_OPS
