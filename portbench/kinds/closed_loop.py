"""``closed_loop``: ``clients`` callers of a served LM, each sending its
next request when its last one resolves.

Parameters (``portbench/traffic/<mix>.json``):

* ``source`` — where the lengths come from;
* ``clients``;
* ``prompt_tokens``, ``output_tokens`` — closed ranges ``[lo, hi]``.
  Every round holds one request per client, with the ``clients``
  midpoints of equal strata of each range, paired in a seeded order, so
  every seed asks for the same work in another order, with other token
  ids (uniform over the vocabulary);
* ``engine`` (``batch_slots``, ``max_len``) and ``service``
  (``max_batch``, ``max_wait_s``) — the system's serving arena and
  micro-batcher;
* ``check_requests`` — how many resolved requests the check compares: the
  one that served the most tokens and others drawn from the seed.

A round goes out at the first completion of the one before, and only
while the window has room for it: what is left of the window must be at
least as long as the round before took. A request counts when its future
resolves inside the window. With ``--trace 1`` the profiler records one
whole round from the window's middle; its recording ends when the round
does and its events are read after the window.

The system (``portbench/systems/<system>.py``) gives:

* ``serving(run)``, which builds the program from the seed and warms
  every shape the mix uses (all of it set-up), and returns an object with
  ``submit(prompt, max_new) -> (future, tokens)`` (``tokens()`` the
  served token ids once the future resolved), ``counters()`` (the
  program's counters, ``decode_steps``, ``slot_steps``, ``batch_slots``,
  ``max_len``, ``completed`` and ``batches`` among them),
  ``queue_spans()`` (the front end's ``(start_s, end_s, batch)`` queue
  spans), ``drain(timeout)`` and ``close()``;
* ``check(run, sample, served)``, run after the window once the program
  is freed;
* ``expected_launches(config, work)``, the launches a traced round's
  work implies (``{kernel name pattern: count}``): a slice that holds
  fewer (the profiler dropped records) is marked incomplete, and the
  readers of its device time say nothing.
"""

from __future__ import annotations

import math
import sys
import threading
import time
from typing import Dict, List

import numpy as np

from portbench import seeds
from portbench.trace import DeviceTrace

__all__ = ["check", "stratified", "Round", "round_of", "run", "sample"]


def check(name: str, spec: Dict) -> None:
    for key in ("prompt_tokens", "output_tokens"):
        lo, hi = spec[key]
        if not 1 <= lo <= hi:
            raise ValueError(f"traffic {name}: {key} {spec[key]} is not a "
                             "range of whole numbers >= 1")
    need = spec["prompt_tokens"][1] + spec["output_tokens"][1]
    if need > spec["engine"]["max_len"]:
        raise ValueError(f"traffic {name}: the longest request needs {need} "
                         f"positions, the arena holds "
                         f"{spec['engine']['max_len']}")
    if int(spec["clients"]) < 1 or int(spec["check_requests"]) < 1:
        raise ValueError(f"traffic {name}: needs clients and "
                         "check_requests >= 1")


def stratified(lo: int, hi: int, n: int) -> np.ndarray:
    """The midpoints of ``n`` equal strata of the whole numbers lo..hi."""
    width = hi - lo + 1
    return lo + np.floor((np.arange(n) + 0.5) * width / n).astype(np.int64)


class Round:
    """One round: client i's request is prompt ``prompts[i]`` (int32 ids)
    with budget ``outputs[i]``."""

    def __init__(self, prompts: List[np.ndarray], outputs: List[int]):
        self.prompts = prompts
        self.outputs = outputs


def round_of(spec: Dict, seed: int, index: int, vocab: int) -> Round:
    """Round ``index`` of the mix for ``seed``."""
    n = int(spec["clients"])
    g = seeds.rng(seed, f"traffic.round.{index}")
    plens = g.permutation(stratified(*spec["prompt_tokens"], n))
    olens = g.permutation(stratified(*spec["output_tokens"], n))
    prompts = [g.integers(0, vocab, size=int(p), dtype=np.int32)
               for p in plens]
    return Round(prompts, [int(o) for o in olens])


class _Loop:
    """Client i sends round k's i-th request when its round k - 1
    request resolves, while the window has room for round k."""

    def __init__(self, run, served):
        self.run, self.served = run, served
        self.spec = run.traffic
        self.vocab = int(run.config["vocab_size"])
        self.rounds: Dict[int, Round] = {}
        self.records: List[Dict] = []
        self.lock = threading.Lock()
        self.idle = threading.Condition(self.lock)
        self.pending = 0
        self.t_end = math.inf
        self.sent: Dict[int, float] = {}
        #: round -> whether it goes out, decided at the first completion
        #: of the round before
        self.go: Dict[int, bool] = {}
        #: ``on_round(k, go)`` at the first completion of round k - 1,
        #: before any request of round k is sent; the card is idle then
        self.on_round = None

    def round(self, k: int) -> Round:
        if k not in self.rounds:
            self.rounds[k] = round_of(self.spec, self.run.seed, k,
                                      self.vocab)
            self.rounds.pop(k - 2, None)
        return self.rounds[k]

    def submit(self, client: int, k: int) -> None:
        r = self.round(k)
        with self.lock:
            self.pending += 1
        t = time.perf_counter()
        with self.lock:
            self.sent.setdefault(k, t)
        fut, tokens = self.served.submit(r.prompts[client],
                                         r.outputs[client])
        fut.add_done_callback(
            lambda f: self.done(client, k, t, r, tokens, f))

    def done(self, client: int, k: int, t_submit: float, r: Round, tokens,
             fut) -> None:
        t = time.perf_counter()
        err = fut.exception()
        rec = {"client": client, "round": k,
               "prompt": len(r.prompts[client]),
               "asked": r.outputs[client], "t_submit": t_submit,
               "t_done": t, "error": err is not None,
               "tokens": None if err else list(tokens()),
               "prompt_ids": r.prompts[client]}
        with self.lock:
            self.records.append(rec)
            if k + 1 not in self.go:
                # the first completion of round k: round k + 1 goes out
                # only if the window holds another round as long
                took = t - self.sent[k]
                if self.on_round is not None:
                    self.on_round(k + 1, t + took <= self.t_end)
                self.go[k + 1] = time.perf_counter() + took <= self.t_end
            go = self.go[k + 1]
        if go:
            self.submit(client, k + 1)
        with self.lock:
            self.pending -= 1
            self.idle.notify_all()

    def start(self) -> None:
        self.go[0] = True
        for c in range(int(self.spec["clients"])):
            self.submit(c, 0)

    def wait_idle(self, timeout: float) -> None:
        with self.lock:
            if not self.idle.wait_for(lambda: self.pending == 0, timeout):
                raise TimeoutError(f"{self.pending} requests unresolved "
                                   f"{timeout} s after the window")


def run(run, system) -> None:
    served = system.serving(run)
    try:
        loop = _Loop(run, served)
        tracer = DeviceTrace(run.device) if run.trace else None
        if tracer is not None:
            tracer.prepare()
        run.mark("tracer")
        _window(run, loop, served, tracer)
        run.memory_peak_bytes = _memory_peak(run.device)
    finally:
        served.close()
    records = loop.records
    run.records = [r for r in records if r["t_done"] <= run.t1]
    run.attempted = sum(r["t_submit"] < run.t1 for r in records)
    run.failed = sum(r["error"] for r in records)
    if tracer is not None:
        run.slice = tracer.slice()
    if run.slice is not None:
        print("portbench: " + run.slice.check_launches(
            system.expected_launches(run.config, run.slice.work)),
            file=sys.stderr, flush=True)
    # a window shorter than a round resolves nothing inside it: its
    # answers come late, not wrong, and are checked all the same
    system.check(run, sample(run, run.records or records), served)


def _memory_peak(device):
    if device.type != "cuda":
        return None
    import torch
    return int(torch.cuda.max_memory_allocated(device))


def _window(run, loop, served, tracer) -> None:
    traced: Dict = {}

    def on_round(k: int, go: bool) -> None:
        if k == 1:
            # round 0's length sets which round lies in the window's middle
            rounds = run.seconds / max(time.perf_counter() - run.t0, 1e-3)
            traced["middle"] = max(1, int(rounds / 2))
        if tracer is None:
            return
        if tracer.recording:
            tracer.stop(work=_work(served, traced["before"],
                                   loop.round(k - 1)))
        elif go and k == traced["middle"]:
            traced["before"] = served.counters()
            # the traced round and what follows it are not counted in
            # the rates read from this run
            run.traced_round = k
            tracer.start()

    loop.on_round = on_round
    run.counters["before"] = served.counters()
    run.setup_s = time.perf_counter() - run.t_process
    run.t0 = time.perf_counter()
    loop.t_end = run.t1 = run.t0 + run.seconds
    loop.start()
    time.sleep(max(0.0, loop.t_end - time.perf_counter()))
    loop.wait_idle(timeout=600.0)
    served.drain(timeout=60.0)
    if tracer is not None and tracer.recording:
        tracer.stop(work=_work(served, traced["before"],
                               loop.round(run.traced_round)))
    run.counters["after"] = served.counters()
    spans = [sp for sp in served.queue_spans() if run.t0 <= sp[0]]
    run.spans["service.queue"] = [(a, b) for a, b, _ in spans
                                  if b <= run.t1]
    _report_rounds(run, loop, spans)


def _work(served, before: Dict, rnd: Round) -> Dict:
    """What the traced round held, for the readers of its slice."""
    after = served.counters()
    return {"prompts": [len(p) for p in rnd.prompts],
            "decode_steps": after["decode_steps"] - before["decode_steps"],
            "slot_steps": after["slot_steps"] - before["slot_steps"],
            "batch_slots": after["batch_slots"],
            "max_len": after["max_len"]}


def _report_rounds(run, loop, spans) -> None:
    """Each round's requests, first send and last completion (seconds
    from the window's start), and the micro-batches the front end formed,
    on standard error."""
    rounds: Dict[int, List] = {}
    for r in loop.records:
        rounds.setdefault(r["round"], []).append(r)
    lines = [f"round {k}: {len(v)} requests, sent "
             f"{min(r['t_submit'] for r in v) - run.t0:.3f} s, done "
             f"{max(r['t_done'] for r in v) - run.t0:.3f} s"
             for k, v in sorted(rounds.items())]
    batches = {b: n for _, b, n in spans}
    lines.append("micro-batches: " + " ".join(
        str(n) for _, n in sorted(batches.items())))
    print("portbench: " + "; ".join(lines), file=sys.stderr, flush=True)


def sample(run, records: List[Dict]) -> List[Dict]:
    """The requests the check compares: the one that served the most
    tokens, and ``check_requests - 1`` others drawn from the seed."""
    done = [r for r in records if not r["error"]]
    if not done:
        return []
    n = int(run.traffic["check_requests"])
    longest = max(range(len(done)), key=lambda i: len(done[i]["tokens"]))
    rest = [i for i in range(len(done)) if i != longest]
    pick = seeds.rng(run.seed, "check.sample").permutation(len(rest))
    return [done[longest]] + [done[rest[i]] for i in pick[:n - 1]]
