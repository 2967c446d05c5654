"""The plain references against the port at smoke sizes on the CPU, and
their controls failing the cells' checks."""

import math

import torch

from _portbench_cpu import (CNN_TRAFFIC, LM_TRAFFIC, run_cpu, smoke_cnn,
                            smoke_lm)

from portbench import loadgen, seeds
from portbench.reference import lm as lm_ref
from portbench.reference import resnet9 as cnn_ref
from portbench.systems import cnn_program, lm_engine

CPU = torch.device("cpu")
SEED = 2 ** 33 + 11


def _lm_inputs(cfg):
    params = lm_ref.make_params(cfg, SEED, CPU)
    calib = torch.as_tensor(seeds.rng(SEED, "t").integers(0, 512, 16))
    lm_ref.calibrate_alpha_a(params, cfg, calib)
    return params


def test_lm_inputs_are_deterministic_and_in_the_port_layout():
    from repro_torch.models.transformer import init_params
    cfg = smoke_lm()
    a, b = _lm_inputs(cfg), _lm_inputs(cfg)
    port = init_params(torch.Generator().manual_seed(0),
                       lm_engine.model_config(cfg))

    def shapes(t, out, pre=""):
        for k, v in t.items() if isinstance(t, dict) else enumerate(t):
            if torch.is_tensor(v):
                out[pre + str(k)] = tuple(v.shape)
            else:
                shapes(v, out, f"{pre}{k}/")
        return out

    assert shapes(a, {}) == shapes(port, {})
    assert torch.equal(a["groups"][0]["attn"]["wq"]["w"],
                       b["groups"][0]["attn"]["wq"]["w"])
    assert (a["groups"][0]["mlp"]["w_down"]["alpha_a"] > 0).all()


def test_lm_reference_equals_the_ports_forward():
    from repro_torch.models.transformer import forward, serve_policy
    from repro_torch.serving.placement import serving_params
    cfg = smoke_lm()
    params = _lm_inputs(cfg)
    mcfg = serve_policy(lm_engine.model_config(cfg), pack_acts=True)
    packed = serving_params(mcfg, params, device=CPU)
    tokens = torch.as_tensor(seeds.rng(SEED, "p").integers(0, 512, 24))
    with torch.no_grad():
        port, _ = forward(packed, {"tokens": tokens[None]}, mcfg)
    want = lm_ref.forward_rows(params, cfg, [tokens],
                               [torch.arange(24)])[0]
    got = port[0].float()
    # the port's head rounds its logits to bf16: half an ulp of |x| < 8
    assert (got - want).abs().max() <= 2 ** -6
    gaps = lm_engine.served_gaps(want, got.argmax(-1).tolist())
    assert gaps.max() <= 2 ** -5


def test_lm_system_is_correct_and_its_control_is_not():
    run, line = run_cpu("stablelm.decode_b32", smoke_lm(),
                        LM_TRAFFIC, seconds=1.0)
    assert line["correct"] and line["failed"] == 0 and run.records
    assert math.isfinite(line["metrics"]["tokens_per_s"]["value"])
    # the control: int4 activations in the program's place
    run.control = True
    sample = loadgen.kind("closed_loop").sample(run, run.records)
    params = _lm_inputs_for(run)
    logits = lm_engine.reference_rows(params, run.config, sample)
    low = lm_engine.reference_rows(params, run.config, sample, a_bits=4)
    gap = max(float(lm_engine.served_gaps(a, b.argmax(-1).tolist()).max())
              for a, b in zip(logits, low))
    print("lm control gap", gap)
    assert gap > run.limit("max_logit_gap")


def _lm_inputs_for(run):
    params = lm_ref.make_params(run.config, run.seed, CPU)
    calib = seeds.rng(run.seed, "lm.calib").integers(
        0, int(run.config["vocab_size"]),
        size=int(run.config["serving"]["calib_tokens"]))
    lm_ref.calibrate_alpha_a(params, run.config, torch.as_tensor(calib))
    return params


def test_cnn_system_is_correct_and_its_control_is_not():
    run, line = run_cpu("resnet9.offline_b256", smoke_cnn(),
                        CNN_TRAFFIC, seconds=0.5)
    assert line["correct"] and line["attempted"] > 0
    assert line["checks"]["max_err"]["value"] < 1e-5
    cfg = run.config
    params = cnn_ref.make_params(cfg, run.seed, CPU)
    calib = cnn_ref.make_images(cfg, run.seed, "cnn.calib",
                                int(cfg["calib_images"]), CPU)
    steps = cnn_ref.calibrate(params, cfg, calib)
    x = cnn_ref.make_images(cfg, run.seed, "probe", 64, CPU)
    want = cnn_ref.forward(params, cfg, steps, x)
    low = cnn_ref.forward(params, cfg, steps, x, host_tf32=True)
    numbers = cnn_program._numbers(cnn_program.image_errors(low, want))
    print("cnn control", numbers)
    assert any(v > run.limit(k) for k, v in numbers.items())


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0, 1 + 2 ** -11, 1 + 3 * 2 ** -11, -3.14159265])
    assert cnn_ref.tf32_round(x).tolist() == [1.0, 1.0, 1 + 2 ** -9,
                                              -3.140625]
