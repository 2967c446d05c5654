#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one NVIDIA card and hold
every hand-written kernel against its plain PyTorch version.

    python3 chip_smoke.py            # from the root of a checkout

Phases (any failure exits non-zero and prints no result):

1. versions, the card's name and power limit, and the kernels' build with
   ``nvcc`` from ``src/repro_torch/kernels/csrc`` (both sources at once);
2. K1 (quantize_pack) against its plain version at the main path's shapes
   (batch 32) plus a ragged row, ``torch.equal``;
3. K2 (bitserial_conv2d) against its plain version at all eight ResNet9
   conv geometries (batch 32) in each step's output mode, a ragged case
   and wider specs, exact equality (the float mode included: both compute
   the same FMA of the same accumulator);
4. the server slice: ``CNNServer`` compiles full-width ResNet9 W2A2 on the
   card and answers requests of batch 1, 3 and 32; launch counts are reset
   just before and read just after, and must be 3 (K1) and 8 (K2) per
   forward; the logits must equal those of the same Program run through
   the plain versions on the card, and a Program calibrated on a small
   batch must agree on argmax with the plain quantized reference forward;
5. times at batch 32: each kernel (CUDA events per launch, L2 flushed
   before each), its plain version, the PyTorch library call that does the
   integer-accumulate part where there is one, and the least time the card
   could take; the forward's img/s and a profiler breakdown.

Standard output ends with the ``kernels`` JSON line, the card's
``nvidia-smi`` name/power line and the ``{"ok": true, ...}`` line; the full
record goes to ``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(ROOT, "chiprun_out")

# published H100 SXM peaks (NVIDIA data sheet, dense), for the bounds
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
FP32_OPS_PER_S = 67e12

B = 32  # the main path's batch for shapes and times

# (name, c_in, c_out, stride, H_in, output mode) of ResNet9's conv1..conv8
RESNET9_CONVS = (
    ("conv1", 64, 64, 1, 32, "packed"),
    ("conv2", 64, 64, 1, 32, "packed"),
    ("conv3", 64, 128, 2, 32, "packed"),
    ("conv4", 128, 128, 1, 16, "codes"),
    ("conv5", 128, 256, 2, 8, "packed"),
    ("conv6", 256, 256, 1, 4, "codes"),
    ("conv7", 256, 512, 2, 2, "packed"),
    ("conv8", 512, 512, 1, 1, "float"),
)


def log(*a):
    print(*a, flush=True)


def sh(cmd):
    return subprocess.run(cmd, capture_output=True, text=True,
                          timeout=60).stdout.strip()


class Timer:
    """Median device time of one call, from CUDA events around each launch,
    with L2 flushed (a 256 MB write) before every launch."""

    def __init__(self, torch, device):
        self.torch = torch
        self.flush = torch.empty(64 * 1024 * 1024, dtype=torch.int32,
                                 device=device)

    def __call__(self, fn, reps):
        torch = self.torch
        fn()
        torch.cuda.synchronize()
        events = []
        for _ in range(reps):
            self.flush.zero_()
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            events.append((s, e))
        torch.cuda.synchronize()
        return statistics.median(s.elapsed_time(e) for s, e in events)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import numpy as np
    from repro_torch.compiler import executor
    from repro_torch.core import pipeline_modules
    from repro_torch.core.bitserial import SerialSpec, conv_out_hw
    from repro_torch.core.quant import QuantSpec, init_alpha, qrange
    from repro_torch.kernels import _build
    from repro_torch.kernels import bitserial_conv as k2
    from repro_torch.kernels import quantize_pack as k1
    from repro_torch.launch.serve import CNNServer
    from repro_torch.models import resnet

    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    pipeline_modules.disable_tf32()
    torch.backends.cudnn.deterministic = True
    os.makedirs(OUT_DIR, exist_ok=True)
    record = {}

    # ---------------------------------------------------------- 1. setup
    smi = sh(["nvidia-smi", "--query-gpu=name,power.limit",
              "--format=csv,noheader"]).splitlines()[0]
    nvcc_ver = sh([_build.nvcc_path(), "--version"]).splitlines()[-1]
    import importlib.util
    has_triton = importlib.util.find_spec("triton") is not None
    log(f"python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} triton {'yes' if has_triton else 'no'}")
    log(f"nvcc: {nvcc_ver}")
    log(f"card: {smi}")
    record["env"] = {"torch": torch.__version__, "cuda": torch.version.cuda,
                     "nvcc": nvcc_ver, "triton": has_triton, "card": smi,
                     "python": sys.version.split()[0]}
    t0 = time.perf_counter()
    kernels = _build.build_all([k1.KERNEL, k2.KERNEL])
    record["build_s"] = time.perf_counter() - t0
    log(f"built {[k.name for k in kernels]} in {record['build_s']:.2f} s")
    for k in kernels:
        for line in k.build_log().splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {k.name}: {line.strip()}")

    rng = np.random.default_rng(0)
    max_err = {"K1": 0.0, "K2": 0.0}

    def cuda(a):
        return torch.from_numpy(np.array(a, order="C")).to(dev)

    def check_equal(kid, what, got, ref):
        torch.cuda.synchronize()
        if got.shape != ref.shape or got.dtype != ref.dtype:
            raise AssertionError(f"{kid} {what}: {tuple(got.shape)} "
                                 f"{got.dtype} vs {tuple(ref.shape)} {ref.dtype}")
        err = float((got.double() - ref.double()).abs().max()) if got.numel() else 0.0
        max_err[kid] = max(max_err[kid], err)
        if not torch.equal(got, ref):
            n = int((got != ref).sum())
            raise AssertionError(f"{kid} {what}: {n} elements differ "
                                 f"(max abs {err})")
        log(f"  {kid} {what}: equal {tuple(got.shape)}")

    # ------------------------------------------------------ 2. K1 checks
    log("K1 quantize_pack vs plain")
    k1_shapes = []
    x = np.maximum(rng.standard_normal((B * 32 * 32, 64)), 0).astype(np.float32)
    alpha = init_alpha(cuda(x), QuantSpec(2, True))
    xq = cuda(x)
    # plant exact .5 boundaries: round half to even must agree
    xq[:64, 0] = (torch.arange(64, device=dev, dtype=torch.float32) * 0.5
                  - 4.0) * alpha
    k1_shapes.append(("conv1.in_q", "f32", xq, alpha, QuantSpec(2, True)))
    for rows, l in ((B * 8 * 8, 128), (B * 2 * 2, 256)):
        codes = cuda(rng.integers(-2, 2, (rows, l)).astype(np.int32))
        k1_shapes.append((f"pack_codes ({rows},{l})", "codes", codes, None, 2))
    for name, kind, t, a, spec in k1_shapes:
        if kind == "f32":
            check_equal("K1", name, k1.quantize_pack_cuda(t, a, spec),
                        k1.quantize_pack_ref(t, a, spec))
        else:
            check_equal("K1", name, k1.pack_codes_cuda(t, spec),
                        k1.pack_codes_ref(t, spec))
    for bits, signed in ((4, True), (3, False), (8, True), (16, True)):
        t = cuda((rng.standard_normal((13, 70)) * 4).astype(np.float32))
        a = torch.tensor(0.37, device=dev)
        spec = QuantSpec(bits, signed)
        check_equal("K1", f"ragged (13,70) {bits}b {'s' if signed else 'u'}",
                    k1.quantize_pack_cuda(t, a, spec),
                    k1.quantize_pack_ref(t, a, spec))
        c = cuda(rng.integers(*qrange(bits, signed), (13, 70)).astype(np.int32))
        check_equal("K1", f"ragged codes (13,70) {bits}b",
                    k1.pack_codes_cuda(c, bits), k1.pack_codes_ref(c, bits))

    # ------------------------------------------------------ 3. K2 checks
    log("K2 bitserial_conv2d vs plain")

    def conv_case(n, h, ci, co, stride, spec, mode, fs=3, pad=1):
        la, ha = qrange(spec.a_bits, spec.a_signed)
        lw, hw = qrange(spec.w_bits, spec.w_signed)
        xc = cuda(rng.integers(la, ha + 1, (n * h * h, ci)).astype(np.int32))
        wc = cuda(rng.integers(lw, hw + 1, (fs * fs * co, ci)).astype(np.int32))
        xp = k1.pack_codes_ref(xc, spec.a_bits).reshape(
            spec.a_bits, n, h, h, -1).contiguous()
        wp = k1.pack_codes_ref(wc, spec.w_bits).reshape(
            spec.w_bits, fs, fs, co, -1).permute(0, 1, 2, 4, 3).contiguous()
        scale = cuda((rng.random(co) * 0.02 + 0.005).astype(np.float32))
        bias = cuda((rng.standard_normal(co) * 0.1).astype(np.float32))
        kw = dict(spec=spec, ci=ci, stride=stride, padding=pad, relu=True)
        if mode != "float":
            rq = QuantSpec(2, True)
            kw.update(requant=rq, requant_scale=torch.tensor(0.25, device=dev),
                      emit_packed=mode == "packed")
        return xp, wp, scale, bias, kw

    w2a2 = SerialSpec(2, 2, True, True, 7)
    k2_cases = []
    for name, ci, co, stride, h, mode in RESNET9_CONVS:
        k2_cases.append((name, conv_case(B, h, ci, co, stride, w2a2, mode)))
    for mode in ("float", "codes", "packed"):
        k2_cases.append((f"ragged ci48 co40 s2 {mode}",
                         conv_case(3, 9, 48, 40, 2, w2a2, mode)))
    for spec, tag in ((SerialSpec(8, 4, True, True, 8), "W4A8"),
                      (SerialSpec(8, 8, True, True, 8), "W8A8"),
                      (SerialSpec(5, 3, False, True, 7), "W3A5 unsigned acts"),
                      (SerialSpec(16, 16, True, True, 7), "W16A16 (int32 wrap)")):
        for mode in ("float", "packed"):
            k2_cases.append((f"{tag} {mode}",
                             conv_case(2, 7, 96, 72, 1, spec, mode)))
    k2_cases.append(("1x1 s2 pad0 W4A4 codes",
                     conv_case(2, 8, 33, 17, 2, SerialSpec(4, 4, True, True, 8),
                               "codes", fs=1, pad=0)))
    k2_cases.append(("5x5 pad2 W2A2 float",
                     conv_case(2, 6, 32, 16, 1, w2a2, "float", fs=5, pad=2)))
    for name, (xp, wp, scale, bias, kw) in k2_cases:
        check_equal("K2", name,
                    k2.bitserial_conv2d_cuda(xp, wp, scale, bias, **kw),
                    k2.bitserial_conv2d_ref(xp, wp, scale, bias, **kw))

    # ------------------------------------------------- 4. the server slice
    log("server slice: CNNServer(seed=0, calib_batch=8) on the card")
    t0 = time.perf_counter()
    server = CNNServer(seed=0, calib_batch=8, max_batch=32)
    torch.cuda.synchronize()
    record["compile_s"] = time.perf_counter() - t0
    log(f"  compiled full-width ResNet9 W2A2 in {record['compile_s']:.2f} s")
    prog = server.program
    plain = executor.make_plain_runner(prog)
    images = np.random.default_rng(7).random((32, 32, 32, 3), dtype=np.float32)
    for k in kernels:
        k.launches = 0
    forwards = 0
    answers = {}
    for n in (1, 3, 32):
        before = (k1.KERNEL.launches, k2.KERNEL.launches)
        answers[n] = server.classify(images[:n])
        forwards += 1
        got = (k1.KERNEL.launches - before[0], k2.KERNEL.launches - before[1])
        if got != (3, 8):
            raise AssertionError(f"batch {n}: launches K1, K2 = {got}, "
                                 "want (3, 8)")
    launches = {"K1": k1.KERNEL.launches, "K2": k2.KERNEL.launches}
    if launches != {"K1": 3 * forwards, "K2": 8 * forwards}:
        raise AssertionError(f"main path launches {launches}")
    log(f"  main path: {forwards} forwards, launches {launches}")
    for n, logits in answers.items():
        if logits.shape != (n, 10) or not np.all(np.isfinite(logits)):
            raise AssertionError(f"batch {n}: bad logits {logits.shape}")
        bucket = executor.bucket_for(n, server.runner.max_batch)
        xb = torch.zeros((bucket, 32, 32, 3), device=dev)
        xb[:n] = torch.from_numpy(images[:n]).to(dev)
        ref = plain(prog.params, xb)[:n].cpu().numpy()
        if not np.array_equal(logits, ref):
            raise AssertionError(f"batch {n}: logits differ from the plain "
                                 f"run, max {np.abs(logits - ref).max()}")
        log(f"  batch {n}: logits equal the plain run; first {logits[0, :4]}")
    record["logits_b3"] = answers[3].tolist()

    # a Program calibrated on the batch it classifies agrees on argmax
    # with the plain quantized reference forward (batch-own step sizes)
    params = resnet.resnet9_init(0)
    small = np.random.default_rng(3).random((4, 32, 32, 3), dtype=np.float32)
    sprog = resnet.resnet9_compile(params, small, device=dev)
    out = sprog(torch.from_numpy(small).to(dev)).cpu().numpy()
    refq = resnet.resnet9_forward(params, torch.from_numpy(small).to(dev)
                                  ).cpu().numpy()
    if not (np.all(np.isfinite(out)) and
            np.array_equal(out.argmax(-1), refq.argmax(-1))):
        raise AssertionError(f"argmax {out.argmax(-1)} vs reference "
                             f"{refq.argmax(-1)}")
    log(f"  calibrated-on-batch argmax {out.argmax(-1).tolist()} equals the "
        "reference forward's")

    # ---------------------------------------------------------- 5. times
    log(f"times at batch {B} (ms, median, L2 flushed before each launch)")
    timer = Timer(torch, dev)
    rows = []

    def k1_bound(r, l, bits, in_bytes):
        byt = r * l * in_bytes + bits * r * (-(-l // 32)) * 4 + 4
        ops = 4 * r * l
        return byt, ops, max(byt / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S) * 1e3

    for name, kind, t, a, spec in k1_shapes:
        r, l = t.shape
        if kind == "f32":
            fk = lambda: k1.quantize_pack_cuda(t, a, spec)
            fp = lambda: k1.quantize_pack_ref(t, a, spec)
            bits = spec.bits
        else:
            fk = lambda: k1.pack_codes_cuda(t, spec)
            fp = lambda: k1.pack_codes_ref(t, spec)
            bits = spec
        byt, ops, bound = k1_bound(r, l, bits, 4)
        rows.append({"kernel": "K1", "call": name, "ms": timer(fk, 50),
                     "plain_ms": timer(fp, 10), "library_ms": None,
                     "bound_ms": bound, "bytes": byt, "ops": ops,
                     "bound_by": "bytes" if byt / HBM_BYTES_PER_S >=
                     ops / FP32_OPS_PER_S else "operations"})
    for (name, (xp, wp, scale, bias, kw)), (_, ci, co, stride, h, mode) in zip(
            k2_cases[:8], RESNET9_CONVS):
        ho, wo = conv_out_hw(h, h, 3, 3, stride, 1)
        macs = B * ho * wo * co * 9 * ci
        out_bytes = {"packed": 2 * B * ho * wo * (-(-co // 32)) * 4,
                     "codes": B * ho * wo * co, "float": B * ho * wo * co * 4}
        byt = (xp.numel() + wp.numel()) * 4 + 8 * co + 4 + out_bytes[mode]
        ops = 2 * macs
        bound = max(byt / HBM_BYTES_PER_S, ops / INT8_OPS_PER_S) * 1e3
        xa = torch.from_numpy(rng.integers(-2, 2, (B, ci, h, h)).astype(
            np.float16)).to(dev).contiguous(memory_format=torch.channels_last)
        wa = torch.from_numpy(rng.integers(-2, 2, (co, ci, 3, 3)).astype(
            np.float16)).to(dev).contiguous(memory_format=torch.channels_last)
        lib = lambda: torch.nn.functional.conv2d(xa, wa, stride=stride,
                                                 padding=1)
        rows.append({
            "kernel": "K2", "call": name, "ms": timer(
                lambda: k2.bitserial_conv2d_cuda(xp, wp, scale, bias, **kw), 50),
            "plain_ms": timer(
                lambda: k2.bitserial_conv2d_ref(xp, wp, scale, bias, **kw), 10),
            "library_ms": timer(lib, 50), "bound_ms": bound, "bytes": byt,
            "ops": ops, "bound_by": "bytes" if byt / HBM_BYTES_PER_S >=
            ops / INT8_OPS_PER_S else "operations"})
    for r in rows:
        lib = "-" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
        log(f"  {r['kernel']} {r['call']:<22} kernel {r['ms']:.4f}  plain "
            f"{r['plain_ms']:.4f}  library {lib}  bound {r['bound_ms']:.5f} "
            f"({r['bound_by']})")
    record["calls"] = rows

    # the forward at batch 32: img/s on the host clock, device time by
    # kernel from the profiler
    x32 = torch.from_numpy(images).to(dev)
    run = server.runner

    def forward_s(x, reps=20):
        run(x)
        torch.cuda.synchronize()
        walls = []
        for _ in range(reps):
            t0 = time.perf_counter()
            run(x)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        return statistics.median(walls)

    record["forward_b1_ms"] = forward_s(x32[:1]) * 1e3
    fwd_s = forward_s(x32)
    t0 = time.perf_counter()
    server.classify(images)
    classify_s = time.perf_counter() - t0
    record["forward_b32_ms"] = fwd_s * 1e3
    record["img_per_s_b32"] = 32 / fwd_s
    record["classify_b32_ms"] = classify_s * 1e3
    log(f"forward batch 32: {fwd_s * 1e3:.3f} ms ({32 / fwd_s:.1f} img/s); "
        f"classify() with host copies {classify_s * 1e3:.3f} ms; "
        f"forward batch 1: {record['forward_b1_ms']:.3f} ms")
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(5):
            run(x32)
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t0
    by_name = {}
    for evt in prof.key_averages():
        dt = (getattr(evt, "self_device_time_total", None)
              or getattr(evt, "self_cuda_time_total", 0) or 0)
        if dt > 0:
            by_name[evt.key] = by_name.get(evt.key, 0.0) + dt / 5 / 1e3
    busy = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    record["profile_b32"] = {"wall_ms_per_forward": prof_wall / 5 * 1e3,
                             "device_ms_per_forward": busy,
                             "by_name_ms": dict(top)}
    log(f"profile batch 32 per forward: wall {prof_wall / 5 * 1e3:.3f} ms, "
        f"device busy {busy:.3f} ms")
    for k, v in top:
        log(f"  {v:9.4f} ms  {k[:90]}")

    def total(kid, key):
        vals = [r[key] for r in rows if r["kernel"] == kid]
        return None if any(v is None for v in vals) else sum(vals)

    line = {"kernels": [
        {"name": "quantize_pack (K1: quantize_pack + 2x pack_codes)",
         "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/quantize_pack.cu",
         "replaces": "src/repro/kernels/quantize_pack.py:53",
         "launches": launches["K1"], "max_abs_err": max_err["K1"],
         "ms": total("K1", "ms"), "plain_ms": total("K1", "plain_ms"),
         "bound_ms": total("K1", "bound_ms"), "bound_by": "bytes",
         "library_ms": None},
        {"name": "bitserial_conv2d (K2: ResNet9 conv1..conv8)",
         "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/bitserial_conv.cu",
         "replaces": "src/repro/kernels/bitserial_conv.py:153",
         "launches": launches["K2"], "max_abs_err": max_err["K2"],
         "ms": total("K2", "ms"), "plain_ms": total("K2", "plain_ms"),
         "bound_ms": total("K2", "bound_ms"), "bound_by": "operations",
         "library_ms": total("K2", "library_ms")},
    ]}
    record["kernels"] = line["kernels"]
    record["total_s"] = time.perf_counter() - t_start
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump(record, f, indent=1)
    log(f"done in {record['total_s']:.1f} s")
    print(json.dumps(line))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
