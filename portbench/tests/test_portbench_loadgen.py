"""The traffic loader and the kinds' generators: deterministic by seed,
inside their stated ranges, and the same work for every seed."""

import json

import numpy as np
import pytest

from _portbench_cpu import ROOT

from portbench import loadgen, seeds

closed_loop = loadgen.kind("closed_loop")

BIG = 2 ** 33 + 12345


@pytest.mark.parametrize("mix", ["decode_b32", "prefill_long"])
def test_rounds_are_deterministic_and_in_range(mix):
    spec = loadgen.load(mix)
    a = closed_loop.round_of(spec, BIG, 3, 100352)
    b = closed_loop.round_of(spec, BIG, 3, 100352)
    assert a.outputs == b.outputs
    assert all(np.array_equal(x, y) for x, y in zip(a.prompts, b.prompts))
    lo, hi = spec["prompt_tokens"]
    assert len(a.prompts) == spec["clients"]
    assert all(lo <= len(p) <= hi for p in a.prompts)
    assert all(p.dtype == np.int32 and 0 <= p.min() and p.max() < 100352
               for p in a.prompts)
    olo, ohi = spec["output_tokens"]
    assert all(olo <= o <= ohi for o in a.outputs)
    assert max(len(p) for p in a.prompts) + max(a.outputs) <= \
        spec["engine"]["max_len"]


@pytest.mark.parametrize("mix", ["decode_b32", "prefill_long"])
def test_every_seed_and_round_asks_for_the_same_work(mix):
    spec = loadgen.load(mix)
    rounds = [closed_loop.round_of(spec, s, k, 1000)
              for s in (0, 7, BIG) for k in (0, 5)]
    lens = {tuple(sorted(len(p) for p in r.prompts)) for r in rounds}
    outs = {tuple(sorted(r.outputs)) for r in rounds}
    assert len(lens) == 1 and len(outs) == 1
    ids = {tuple(r.prompts[0][:16]) for r in rounds}
    assert len(ids) == len(rounds)    # other token ids per seed and round
    spread = dict(spec, prompt_tokens=[16, 400], output_tokens=[8, 64])
    orders = {tuple(closed_loop.round_of(spread, s, k, 1000).outputs)
              for s in (0, 7, BIG) for k in (0, 5)}
    assert len(orders) > 1            # another order per seed and round


def test_strata_cover_the_range_uniformly():
    v = closed_loop.stratified(64, 448, 32)
    assert v.min() >= 64 and v.max() <= 448 and len(set(v)) == 32
    assert abs(v.mean() - (64 + 448) / 2) <= 1


def test_seeds_take_large_values_and_differ_by_tag():
    assert seeds.derive(BIG, "a") != seeds.derive(BIG, "b")
    assert seeds.derive(BIG, "a") != seeds.derive(BIG + 2 ** 32, "a")
    assert 0 <= seeds.derive(2 ** 40, "x") < 2 ** 63
    with pytest.raises(ValueError):
        seeds.derive(-1, "x")


def test_a_bad_mix_is_refused(tmp_path):
    good = json.loads((ROOT / "portbench/traffic/decode_b32.json")
                      .read_text())
    (tmp_path / "odd.json").write_text(json.dumps(dict(good, kind="open")))
    with pytest.raises(ValueError, match="kind 'open'"):
        loadgen.load("odd", tmp_path)
    too_long = dict(good, output_tokens=[128, 1000])
    (tmp_path / "long.json").write_text(json.dumps(too_long))
    with pytest.raises(ValueError, match="positions"):
        loadgen.load("long", tmp_path)


def test_offline_mix_loads():
    spec = loadgen.load("offline_b256")
    assert spec["batch"] == 256 and spec["in_flight"] >= 1
    assert spec["check_batches"] <= spec["distinct_batches"] * 1000


@pytest.mark.parametrize("mix", ["decode_b32", "prefill_long"])
def test_each_mix_names_its_source_and_fits_its_arena(mix):
    spec = loadgen.load(mix)
    assert spec["source"] and "\n" not in spec["source"]
    need = spec["prompt_tokens"][1] + spec["output_tokens"][1]
    # the arena holds the longest request, rounded up to 64 positions
    assert need <= spec["engine"]["max_len"] < need + 64
