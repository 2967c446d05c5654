"""The metric readers and the device-trace reduction on synthetic runs."""

import math
import types

import pytest

from _portbench_cpu import config, harness

from portbench.trace import Slice, union_seconds
from portbench.work import cnn, lm, peaks


def test_union_and_breakdown():
    assert math.isclose(union_seconds([(0, 10), (5, 15), (30, 35)]), 20e-9)
    sl = Slice([("k", 0, 10), ("j", 5, 10), ("k", 30, 5)], 40e-9)
    assert math.isclose(sl.busy_s, 20e-9)
    count, seconds = sl.kernels("^k$")
    assert count == 2 and math.isclose(seconds, 15e-9)
    b = sl.breakdown()
    assert b["device_ops"][0][0] == "k"
    assert math.isclose(b["device_ops"][0][1], 15e-9)
    (gap, secs), = b["idle_gaps"]
    assert gap == "after j before k" and math.isclose(secs, 15e-9)


def _run(**kw):
    base = dict(records=[], spans={}, counters={}, slice=None, seconds=10.0,
                t0=100.0, memory_peak_bytes=None, setup_s=3.0)
    base.update(kw)
    run = types.SimpleNamespace(**base)
    run.counter_delta = lambda n: (run.counters["after"][n]
                                   - run.counters["before"][n])
    return run


def _req(t_submit, t_done, n, prompt=64, error=False):
    return {"t_submit": t_submit, "t_done": t_done, "prompt": prompt,
            "tokens": None if error else [1] * n, "error": error}


def test_serving_readers():
    recs = [_req(100.0, 101.0 + i / 10, 10) for i in range(20)]
    run = _run(records=recs, config=config("stablelm_2_1_6b_w4a8"))
    assert math.isclose(harness.metric_reader("tokens_per_s")(run), 200 / 2.9)
    # nearest rank: the 19th of 20 sorted latencies
    assert math.isclose(harness.metric_reader("request_p95_ms")(run), 2800)
    work = 20 * lm.request_flops(run.config, 64, 10)
    assert math.isclose(harness.metric_reader("mfu.lm")(run),
                        100 * work / 2.9 / peaks.INT8_OPS)
    run.records += [_req(100.0, 101.0, 0, error=True)] * 2
    assert harness.metric_reader("request_p95_ms")(run) == math.inf


def test_counter_readers():
    run = _run(counters={
        "before": {"completed": 8, "batches": 1, "decode_steps": 10,
                   "slot_steps": 30, "batch_slots": 4, "images": 0},
        "after": {"completed": 72, "batches": 3, "decode_steps": 30,
                  "slot_steps": 70, "batch_slots": 4, "images": 5120}},
        config=config("resnet9_cifar10_w2a2"),
        spans={"executor.call": [(0.0, 0.001), (1.0, 1.003)],
               "service.queue": [(0.0, 0.002)] * 19 + [(0.0, 0.5)]})
    assert harness.metric_reader("service.batch_mean")(run) == 32
    assert harness.metric_reader("engine.slot_occupancy")(run) == 50.0
    assert harness.metric_reader("img_per_s")(run) == 512
    assert math.isclose(harness.metric_reader("executor.enqueue_ms")(run), 2)
    assert math.isclose(harness.metric_reader("service.queue_p95_ms")(run), 2)
    assert math.isclose(harness.metric_reader("mfu.cnn")(run),
                        100 * cnn.image_flops(run.config) * 512
                        / peaks.INT8_OPS)


def test_roofline_readers():
    cfg = config("stablelm_2_1_6b_w4a8")
    k3 = "void bitserial_gemm_kernel<false, A, B, 4>(GemmArgs)"
    sl = Slice([(k3, 0, 10 ** 6), ("other", 0, 10 ** 6)], 0.002,
               {"prompts": [100, 200], "decode_steps": 4,
                "slot_steps": 8})
    run = _run(slice=sl, config=cfg)
    want = 0.0
    for m, times in ((100, 1), (200, 1), (2, 4)):
        want += times * 24 * sum(
            peaks.bound_seconds(*lm.proj_call(m, k, n, 4, 8, b))
            for _, k, n, b in lm.projections(cfg))
    assert math.isclose(harness.metric_reader("k3_roofline")(run),
                        100 * want / 1e-3)
    assert math.isclose(harness.metric_reader("idle_share.lm")(run), 50.0)
    r9 = config("resnet9_cifar10_w2a2")
    k2 = "void bitserial_conv2d_kernel<A, B, 2>(ConvArgs)"
    sl2 = Slice([(k2, i * 10, 5) for i in range(16)], 1e-6, {"batch": 256})
    run2 = _run(slice=sl2, config=r9)
    per = sum(peaks.bound_seconds(*cnn.conv_call_work(c, 2, 2))
              for c in cnn.conv_calls(r9, 256))
    assert math.isclose(harness.metric_reader("k2_roofline")(run2),
                        100 * per * 2 / 80e-9)
    assert harness.metric_reader("k2_roofline")(_run(slice=None)) is None


@pytest.mark.parametrize("name", ["k3_roofline", "idle_share.cnn"])
def test_a_reader_with_nothing_to_read_returns_nothing(name):
    assert harness.metric_reader(name)(_run()) is None


def test_a_slice_short_of_its_launches_is_incomplete():
    k3 = "void bitserial_gemm_kernel<false, A, B, 4>(GemmArgs)"
    sl = Slice([(k3, i * 10, 5) for i in range(3)], 1e-6)
    assert sl.complete is None
    line = sl.check_launches({"bitserial_gemm_kernel<false": 4})
    assert sl.complete is False and "3 of 4" in line
    sl.check_launches({"bitserial_gemm_kernel<false": 3})
    assert sl.complete is True


@pytest.mark.parametrize("name", ["k3_roofline", "idle_share.lm"])
def test_an_incomplete_slice_is_not_read(name):
    cfg = config("stablelm_2_1_6b_w4a8")
    k3 = "void bitserial_gemm_kernel<false, A, B, 4>(GemmArgs)"
    sl = Slice([(k3, 0, 10 ** 6)], 0.002,
               {"prompts": [100], "decode_steps": 0, "slot_steps": 0})
    run = _run(slice=sl, config=cfg)
    assert harness.metric_reader(name)(run) is not None
    sl.complete = False
    assert harness.metric_reader(name)(run) is None
