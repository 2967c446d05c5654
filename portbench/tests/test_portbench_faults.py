"""The check on a run whose timed path is broken underneath: the rest of
a run driven on the CPU (the harness's look for a card skipped), once for
each fault a one-card serving or offline cell can have, and ``correct``
must come out false. (A one-card cell has no exchange between chips to
leave out.)"""

import pytest
import torch

from _portbench_cpu import (CNN_TRAFFIC, LM_TRAFFIC, run_cpu, smoke_cnn,
                            smoke_lm)


def _lm(monkeypatch=None):
    return run_cpu("stablelm.decode_b32", smoke_lm(), LM_TRAFFIC,
                   seconds=0.8)


def _cnn():
    return run_cpu("resnet9.offline_b256", smoke_cnn(),
                   CNN_TRAFFIC, seconds=0.4)


def test_sound_runs_are_correct():
    assert _lm()[1]["correct"]
    assert _cnn()[1]["correct"]


def _wrap_serve(monkeypatch, after):
    from repro_torch.serving import ContinuousLMEngine
    serve = ContinuousLMEngine.serve

    def broken(self, requests):
        return after(serve(self, requests))

    monkeypatch.setattr(ContinuousLMEngine, "serve", broken)
    monkeypatch.setattr(ContinuousLMEngine, "__call__", broken)


def test_a_token_altered_where_it_is_produced(monkeypatch):
    # every served token moved to its neighbour id: at smoke size one
    # such token can lie within the limit of the best (1.494 against 1.5
    # once), so one swapped token alone would make the test a draw
    def alter(reqs):
        for r in reqs:
            if r.out_tokens:
                r.out_tokens = [(t + 1) % 512 for t in r.out_tokens]
        return reqs

    _wrap_serve(monkeypatch, alter)
    run, line = _lm()
    assert not line["correct"]
    assert line["checks"]["max_logit_gap"]["value"] > \
        line["checks"]["max_logit_gap"]["limit"]


def test_a_decode_step_that_returns_its_state_unchanged(monkeypatch):
    from repro_torch.serving import ContinuousLMEngine
    monkeypatch.setattr(ContinuousLMEngine, "_step_fn", lambda self: None)
    run, line = _lm()
    assert not line["correct"]


def test_half_of_the_batch_left_out(monkeypatch):
    def halve(reqs):
        for r in reqs[len(reqs) // 2:]:
            r.out_tokens = r.out_tokens[:1]
        return reqs

    _wrap_serve(monkeypatch, halve)
    run, line = _lm()
    assert not line["correct"]
    assert line["checks"]["wrong_lengths"]["value"] > 0


@pytest.mark.parametrize("fault", ["answer_altered", "half_the_batch"])
def test_cnn_faults(monkeypatch, fault):
    from repro_torch.compiler.executor import BucketedRunner
    call = BucketedRunner.__call__

    def broken(self, x, **kw):
        out = call(self, x, **kw)
        if fault == "answer_altered":
            out = out.clone()
            out[0] = out[0].roll(1)
        else:
            # half the rows computed, the other half their mean
            half = out.shape[0] // 2
            out = torch.cat([out[:half], out[:half].mean(0).expand(
                out.shape[0] - half, -1)])
        return out

    monkeypatch.setattr(BucketedRunner, "__call__", broken)
    run, line = _cnn()
    assert not line["correct"]
