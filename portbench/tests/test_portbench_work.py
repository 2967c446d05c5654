"""The frozen work and byte arithmetic against hand counts."""

import math

import pytest

from _portbench_cpu import config

from portbench.work import cnn, lm, peaks

R9 = config("resnet9_cifar10_w2a2")
LM = config("stablelm_2_1_6b_w4a8")


def test_resnet9_geometry_and_macs():
    calls = cnn.conv_calls(R9, 1)
    assert [(c["h"], c["ho"]) for c in calls] == [
        (32, 32), (32, 32), (32, 16), (16, 16), (8, 4), (4, 4), (2, 1),
        (1, 1)]
    assert [c["out"] for c in calls] == ["packed", "packed", "packed",
                                         "codes", "packed", "codes",
                                         "packed", "float"]
    macs = sum(cnn.conv_call_work(c, 1, 1)[0] / 2 for c in calls)
    hand = (32 * 32 * 64 * 64 * 9 * 2 + 16 * 16 * 128 * 64 * 9
            + 16 * 16 * 128 * 128 * 9 + 4 * 4 * 256 * 128 * 9
            + 4 * 4 * 256 * 256 * 9 + 1 * 1 * 512 * 256 * 9
            + 1 * 1 * 512 * 512 * 9)
    assert macs == hand == 149_815_296
    assert cnn.image_flops(R9) == 2 * (hand + 32 * 32 * 64 * 27 + 512 * 10)


def test_resnet9_conv_bytes_by_hand():
    c1 = cnn.conv_calls(R9, 256)[0]
    ops, nbytes = cnn.conv_call_work(c1, 2, 2)
    assert ops == 2 * 256 * 32 * 32 * 64 * 9 * 64
    weights = 9 * 64 * 64 * 2 / 8
    acts = 256 * 32 * 32 * 64 * 2 / 8
    out = 256 * 32 * 32 * 64 * 2 / 8          # packed at the next a_bits
    assert nbytes == weights + acts + out + 8 * 64
    c8 = cnn.conv_calls(R9, 256)[-1]
    assert cnn.conv_call_work(c8, 2, 2)[1] == (9 * 512 * 512 * 2 / 8
                                               + 256 * 512 * 2 / 8
                                               + 4 * 256 * 512 + 8 * 512)


def test_stablelm_projections_and_token_work():
    proj = lm.projections(LM)
    assert [(n, k, m, b) for n, k, m, b in proj] == [
        ("q", 2048, 2048, True), ("k", 2048, 2048, True),
        ("v", 2048, 2048, True), ("o", 2048, 2048, False),
        ("gate", 2048, 5632, False), ("up", 2048, 5632, False),
        ("down", 5632, 2048, False)]
    per_layer = 4 * 2048 * 2048 + 3 * 2048 * 5632
    t = lm.token_flops(LM, ctx=100, head=True)
    assert t == 24 * (2 * per_layer + 4 * 32 * 64 * 100) + 2 * 2048 * 100352
    assert lm.token_flops(LM, 1, False) < lm.token_flops(LM, 1, True)


@pytest.mark.parametrize("prompt,output", [(64, 1), (64, 128), (4032, 64)])
def test_request_work_is_the_sum_of_its_positions(prompt, output):
    loop = sum(lm.token_flops(LM, c + 1, head=False) for c in range(prompt))
    loop += 2 * 2048 * 100352                     # the prefill's head
    loop += sum(lm.token_flops(LM, prompt + i + 1, head=True)
                for i in range(output - 1))
    assert math.isclose(lm.request_flops(LM, prompt, output), loop,
                        rel_tol=1e-12)


def test_projection_call_bytes_and_bound():
    ops, nbytes = lm.proj_call(32, 2048, 5632, 4, 8)
    assert ops == 2 * 32 * 2048 * 5632
    assert nbytes == 2048 * 5632 / 2 + 32 * 2048 + 4 * 32 * 5632 + 4 * 5632
    # at 32 rows the weights' bytes bound the call
    assert peaks.bound_seconds(ops, nbytes) == nbytes / peaks.HBM_BYTES
    big = lm.proj_call(4096, 2048, 5632, 4, 8)
    assert peaks.bound_seconds(*big) == big[0] / peaks.INT8_OPS


def test_a_traced_round_implies_its_k3_launches():
    from portbench.systems import lm_engine
    cfg = config("stablelm_2_1_6b_w4a8")
    # 24 layers x 7 projections, per prefill and per decode step: a
    # conversation round of 32 prefills and 128 steps, a coding round of
    # 8 and 12 (both as counted in traced rounds on the card)
    for prompts, steps, want in ((32, 128, 26880), (8, 12, 3360)):
        work = {"prompts": [1] * prompts, "decode_steps": steps}
        assert lm_engine.expected_launches(cfg, work) == {lm_engine.K3: want}
