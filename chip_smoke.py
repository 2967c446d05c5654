#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths once on one NVIDIA card and
hold every hand-written kernel against its plain PyTorch version.

    python3 chip_smoke.py            # from the root of a checkout

Phases (any failure exits non-zero and prints no result):

1. versions, the card's name and power limit, and the kernels' build with
   ``nvcc`` from ``src/repro_torch/kernels/csrc`` (all three sources at
   once);
2. K1 (quantize_pack) against its plain version, ``torch.equal``: at the
   CNN path's shapes (batch 32), a ragged row in float32 and bf16, and the
   grouped launch the LM makes (one activation, G = 1..4 step sizes,
   float32 and bf16) at stablelm-1.6b's activation shapes (M = 4 and 64 x
   K = 2048 and 5632) and a ragged (13, 70);
3. K2 (bitserial_conv2d) against its plain version at all eight ResNet9
   conv geometries (batch 32) in each step's output mode, a ragged case,
   wider specs and the edges of its tensor-core tiles (pixels and Co off
   the tile, Ci = 33 and 600, batch 1, stride 2, every output mode), exact
   equality (the float mode included: both compute the same FMA of the
   same accumulator);
4. the CNN slice: ``CNNServer`` compiles full-width ResNet9 W2A2 on the
   card and answers requests of batch 1, 3 and 32; launch counts are reset
   just before and read just after, and must be 3 (K1) and 8 (K2) per
   forward; the logits must equal those of the same Program run through
   the plain versions on the card, and a Program calibrated on a small
   batch must agree on argmax with the plain quantized reference forward;
5. CNN times at batch 32: each kernel (``kernels/timing.py``'s ``Timer``:
   CUDA events around each launch, L2 flushed before each, every
   repetition queued behind a device sleep so that the host's enqueue gap
   is not counted), its plain
   version, the PyTorch library call that does the integer-accumulate part
   where there is one, and the least time the card could take; the
   forward's img/s and a profiler breakdown;
6. K3 (bitserial_matmul_v2) and 7. K4 (bitserial_matmul) against their
   plain versions, ``torch.equal``: stablelm-1.6b's three GEMM shapes at
   M = 4 (decode) and 64 (prefill), W4A8; codes and packed outputs;
   ragged M/K/N; radix 1; W8A8 with unsigned activations; W16A16 whose
   sums wrap int32; K4's requant at 8 and 12 bits; both at the edges of
   their shared tensor-core tile (M = 1, 4, 5, 17, 64 against N = 70,
   K = 100 at W4A8, radix 1, W16A16 and unsigned W8A8);
8. the LM slice: ``Server`` on full-width stablelm-1.6b (24 layers, bf16,
   W4A8, random weights from seed 0) answers four requests (prompts of 5,
   8, 11 and 16 tokens, 16 new tokens each) with counts reset just before
   and read just after: 96 K1 (one per distinct activation: q/k/v share
   one, gate/up another) and 168 K3 launches per prefill and per decode
   step. The tokens and last-step logits must equal the plain
   versions' run on the card, and the K4 path's (``pack_acts=False``,
   counted the same way); a 2-slot server answering one request (a dummy
   slot) must give a 1-slot server's tokens; the smoke config on the card
   must give the CPU's plain-version tokens;
8b. the continuous LM engine: ``ContinuousLMEngine`` on full-width
    stablelm-1.6b (batch_slots 4, max_len 64, seed 0) warms up (one prefill
    per bucket, the insert, the decode step captured once as a CUDA graph:
    96 K1 and 168 K3 counted at capture) and serves the reference CLI's
    mixed load of 16 requests (prompts of 4-16 tokens, every 4th request
    16 new tokens, the others 4), counts reset just before and read just
    after (the wrappers count its 16 prefills; a replay calls no wrapper,
    so the replays add the captured step's launches times the steps run,
    a per-replay count the profiler confirms), with nothing compiled after
    the warmup. Every request's tokens must equal those of the request
    run alone and eagerly at the engine's shapes (its prompt right-padded
    to its bucket and prefilled with ``last_pos``, then decode steps over
    a 4-row cache holding it in every row, all rows alike), and the first
    four those of the engine on the plain versions (``plain=True``, also
    captured) and of the K4 engine (``pack_acts=False``, 168 K4 at
    capture and in one replay's profile, held to its own eager run
    alone). Each request is also served by a 1-slot eager ``Server``
    (batch 1, the prompt unpadded) and the token where the two part, if
    any, is reported with the eager run's gap between its two largest
    logits there: the float parts round by shape on the card. Times: the
    load's tokens/s (a smoke reading) and host time per step; the
    replayed step against the eager ``Server``'s decode step at batch 4
    (host clock, synchronized); one replay under the profiler (wall, busy,
    and its K1/K3 launches by kernel name, which must be 96 and 168);
9. the port's copy of ``tiny_mixed_cnn`` compiled on the card: its
   ``gemm_packed`` step launches K3, and the logits equal the plain
   runner's;
10. LM times: K3 and K4 at each stablelm shape and K1 at each launch a
    layer makes (bf16; G = 3, 1, 2 at K = 2048 and G = 1 at 5632) —
    kernel, plain, bound and the library call for the same integer
    product (``torch._int_mm`` where its shape rules allow, else an fp16
    matmul of the codes) — and their sums over one decode step (M = 4)
    and one prefill (M = 64); K1 at (1, 32), one warp's work, and the
    launch floor under the same timer (``t.zero_()`` on one element); for
    each LM path (K1 + K3 and K4) the prefill, a decode step and
    ``generate``'s tokens/s at batch 4, and a profiler breakdown of one
    prefill and one decode step (device busy counts the card's own events
    only; K1's in-path ms and launches by kernel name, its launches held
    to the wrappers' count).

The ``kernels`` JSON line gives, per kernel, its launches on the main
paths (the engine's loads included: their prefills' wrapper counts plus
the captured step's launches times the replays run, captures left out)
and its times summed over one ResNet9 batch-32 forward plus one LM
decode step at batch 4; K1's entry adds its in-path profiler ms and
launches per decode step and per prefill; K1, K3 and K4 add the engine's
launches per captured decode step, as its ``stats()`` reports them.

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

# the LM slice: stablelm-1.6b at batch 4, prompts of these lengths
LM_PROMPTS = (5, 8, 11, 16)
LM_NEW = 16        # new tokens per request: one prefill + 15 decode steps
LM_MAX_LEN = 64
# (K, N) of stablelm-1.6b's projections: q/k/v/o, gate/up, down, and how
# many of each a layer runs
STABLELM_GEMMS = ((2048, 2048), (2048, 5632), (5632, 2048))
GEMMS_PER_LAYER = (4, 2, 1)
# the K1 launches a layer makes, one per distinct activation: (K, G step
# sizes) for q/k/v, o, gate/up and down
K1_PER_LAYER = ((2048, 3), (2048, 1), (2048, 2), (5632, 1))

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


def tree_to(tree, device):
    """A parameter tree (dicts, lists, tensors) with every tensor moved."""
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_to(v, device) for v in tree]
    return tree.to(device)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import numpy as np
    from repro_torch.compiler import bench_graphs, executor
    from repro_torch.compiler.lower import compile_graph
    from repro_torch.configs import get_arch
    from repro_torch.core import bitops, pipeline_modules
    from repro_torch.core.bitserial import SerialSpec, conv_out_hw, plan_spec
    from repro_torch.core.quant import QuantSpec, init_alpha, qrange
    from repro_torch.kernels import _build
    from repro_torch.kernels import bitserial_conv as k2
    from repro_torch.kernels import bitserial_matmul as km
    from repro_torch.kernels import quantize_pack as k1
    from repro_torch.kernels.timing import Timer
    from repro_torch.launch.serve import CNNServer, GenRequest, Server
    from repro_torch.models import resnet, transformer
    from repro_torch.models.layers import QuantPolicy

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
    kernels = _build.build_all([k1.KERNEL, k2.KERNEL, km.KERNEL])
    record["build_s"] = time.perf_counter() - t0
    log(f"built {[k.name for k in kernels]} in {record['build_s']:.2f} s")
    for k in kernels:
        for line in k.build_log().splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {k.name}: {line.strip()}")

    rng = np.random.default_rng(0)
    max_err = {"K1": 0.0, "K2": 0.0, "K3": 0.0, "K4": 0.0}

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
        check_equal("K1", f"ragged bf16 (13,70) {bits}b "
                    f"{'s' if signed else 'u'}",
                    k1.quantize_pack_cuda(t.bfloat16(), a, spec),
                    k1.quantize_pack_ref(t.bfloat16(), a, spec))
        c = cuda(rng.integers(*qrange(bits, signed), (13, 70)).astype(np.int32))
        check_equal("K1", f"ragged codes (13,70) {bits}b",
                    k1.pack_codes_cuda(c, bits), k1.pack_codes_ref(c, bits))
    # the grouped launch the LM makes: one activation, G = 1..4 step sizes,
    # float32 and bf16, at the LM's shapes and a ragged one
    lm_steps = [torch.tensor(a, device=dev) for a in (0.177, 0.0371, 0.5,
                                                      0.0098)]
    lm_aspec = QuantSpec(8, True)
    for m, k in ((4, 2048), (64, 2048), (4, 5632), (64, 5632), (13, 70)):
        xf = cuda((rng.standard_normal((m, k)) * 4).astype(np.float32))
        for xt in (xf, xf.bfloat16()):
            for g in range(1, 5):
                check_equal("K1", f"({m},{k}) {xt.dtype} G={g}",
                            k1.quantize_pack_multi_cuda(xt, lm_steps[:g],
                                                        lm_aspec),
                            k1.quantize_pack_multi_ref(xt, lm_steps[:g],
                                                       lm_aspec))

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
            rq = QuantSpec(12 if mode == "codes32" else 2, True)
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
    # the edges of the tensor-core tiles: pixels and Co off the 32 x 8 NT
    # tile, Ci = 33 and 600 (19 words per tap), batch 1, stride 2
    for n, h, ci, co, stride in ((1, 9, 33, 40, 2), (1, 5, 600, 70, 1),
                                 (3, 5, 33, 100, 2)):
        for spec, tag in ((w2a2, "W2A2"),
                          (SerialSpec(16, 16, True, True, 7), "W16A16")):
            for mode in ("float", "codes", "codes32", "packed"):
                k2_cases.append((f"edge n{n} h{h} ci{ci} co{co} s{stride} "
                                 f"{tag} {mode}",
                                 conv_case(n, h, ci, co, stride, spec, mode)))
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
    def counts():
        return {"K1": k1.KERNEL.launches, "K2": k2.KERNEL.launches,
                "K3": km.KERNEL.entry_launches["bitserial_matmul_v2"],
                "K4": km.KERNEL.entry_launches["bitserial_matmul_v1"]}

    def reset_counts():
        for k in kernels:
            k.reset_counts()

    reset_counts()
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
    launches = counts()
    if launches != {"K1": 3 * forwards, "K2": 8 * forwards, "K3": 0, "K4": 0}:
        raise AssertionError(f"main path launches {launches}")
    log(f"  main path: {forwards} forwards, launches {launches}")
    record["launches_cnn"] = launches
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
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def device_profile(fn, reps=1):
        """``fn`` run ``reps`` times under the profiler; per run: the host
        wall, the card's busy time (its own events: kernels, copies, sets),
        and the 12 largest kernels' ms and launches by name, K1's apart.
        ``all_rows_ms`` sums self device time over every row, the CPU ops
        included, so it counts each torch op's kernels twice: it is the
        figure reported as device busy before this field existed."""
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        ms, launches, all_rows = {}, {}, 0.0
        for evt in prof.key_averages():
            dt = evt.self_device_time_total / 1e3 / reps
            all_rows += dt
            if evt.device_type == DeviceType.CUDA and dt > 0:
                ms[evt.key] = dt
                launches[evt.key] = evt.count / reps
        if not ms:
            raise AssertionError("the profiler recorded no device event")
        top = sorted(ms, key=lambda k: -ms[k])[:12]
        k1_names = [k for k in ms if "quantize_pack" in k]
        return {"wall_ms": wall / reps * 1e3, "device_ms": sum(ms.values()),
                "all_rows_ms": all_rows,
                "by_name_ms": {k: ms[k] for k in top},
                "launches": {k: launches[k] for k in top},
                "K1_ms": sum(ms[k] for k in k1_names),
                "K1_launches": sum(launches[k] for k in k1_names)}

    log(f"times at batch {B} (ms, median, L2 flushed before each launch)")
    timer = Timer(dev)
    rows = []

    def k1_bound(r, l, bits, in_bytes, groups=1):
        """K1's least time: x read once, G steps, G planes sets written;
        a divide, a round and a clip (counted as 4 float32 ops) per element
        and step."""
        byt = r * l * in_bytes + groups * (bits * r * (-(-l // 32)) * 4 + 4)
        ops = 4 * r * l * groups
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
        fk = lambda: k2.bitserial_conv2d_cuda(xp, wp, scale, bias, **kw)
        rows.append({
            "kernel": "K2", "call": name, "ms": timer(fk, 50),
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
    for kid in ("K1", "K2"):
        sums = {key: sum(r[key] for r in rows if r["kernel"] == kid)
                for key in ("ms", "bound_ms", "plain_ms")}
        lib = [r["library_ms"] for r in rows if r["kernel"] == kid]
        sums["library_ms"] = None if None in lib else sum(lib)
        record[f"{kid}_forward_sums"] = sums
        log(f"  {kid} summed over one batch-{B} forward: {sums['ms']:.4f} "
            f"ms, bound {sums['bound_ms']:.5f}, library {sums['library_ms']}, plain "
            f"{sums['plain_ms']:.3f}")

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
    prof = device_profile(lambda: run(x32), 5)
    record["profile_b32"] = prof
    log(f"profile batch 32 per forward: wall {prof['wall_ms']:.3f} ms, "
        f"device busy {prof['device_ms']:.3f} ms (all profiler rows "
        f"{prof['all_rows_ms']:.3f})")
    for k, v in prof["by_name_ms"].items():
        log(f"  {v:9.4f} ms  {k[:90]}")

    # ------------------------------------------- 6./7. K3 and K4 vs plain
    log("K3 bitserial_matmul_v2 and K4 bitserial_matmul vs plain")
    lm_cfg = get_arch("stablelm-1.6b").full
    w4a8 = plan_spec(lm_cfg.policy.spec())

    def gemm_case(spec, m, k, n, bias=True, scale_mul=1.0):
        la, ha = qrange(spec.a_bits, spec.a_signed)
        lw, hw = qrange(spec.w_bits, spec.w_signed)
        xc = cuda(rng.integers(la, ha + 1, (m, k)).astype(np.int32))
        wc = cuda(rng.integers(lw, hw + 1, (k, n)).astype(np.int32))
        wp = bitops.pack_bitplanes(bitops.pad_to(
            bitops.to_bitplanes(wc, spec.w_bits), 32, axis=1), axis=1)
        scale = cuda((rng.random(n) * 2e-3 * scale_mul + 1e-4).astype(
            np.float32))
        return {"xc": xc, "wc": wc, "xp": k1.pack_codes_ref(xc, spec.a_bits),
                "wp": wp, "scale": scale, "spec": spec, "k": k,
                "bias": cuda(rng.standard_normal(n).astype(np.float32))
                if bias else None}

    rs = torch.tensor(0.37, device=dev)
    # (name, case, K3 modes, K4 modes); a mode is (output, requant)
    gemm_cases = []
    for k, n in STABLELM_GEMMS:
        for m in (4, 4 * 16):
            gemm_cases.append((f"W4A8 M{m} {k}->{n}",
                               gemm_case(w4a8, m, k, n, bias=False),
                               [("float", None)], [("float", None)]))
    rq_modes = [("codes", QuantSpec(8, True)), ("packed", QuantSpec(4, True))]
    k4_rq = [("codes", QuantSpec(8, True)), ("codes", QuantSpec(12, True))]
    gemm_cases += [
        ("W4A8 M64 2048->2048 requant", gemm_case(w4a8, 64, 2048, 2048,
                                                  scale_mul=40),
         rq_modes, k4_rq),
        ("ragged 5x100->70", gemm_case(w4a8, 5, 100, 70, scale_mul=40),
         [("float", None)] + rq_modes, [("float", None)] + k4_rq),
        ("W2A2 radix 1", gemm_case(SerialSpec(2, 2, True, True, 1), 9, 65,
                                   40, scale_mul=40),
         [("float", None)] + rq_modes, [("float", None)] + k4_rq),
        ("W8A8 unsigned acts", gemm_case(SerialSpec(8, 8, False, True, 7),
                                         7, 96, 64, scale_mul=40),
         [("float", None)] + rq_modes, [("float", None)] + k4_rq),
        ("W16A16 (int32 wrap)", gemm_case(SerialSpec(16, 16, True, True, 7),
                                          3, 700, 64),
         [("float", None)] + rq_modes, [("float", None)] + k4_rq)]
    # the edges of the tensor-core tile K3 and K4 share: M = 1..64 rows
    # against 8 NT-row tiles, N = 70 and K = 100 off the 32-column tile and
    # the K word
    for m in (1, 4, 5, 17, 64):
        for spec, tag in ((w4a8, "W4A8"), (SerialSpec(2, 2, True, True, 1),
                                           "W2A2 radix 1"),
                          (SerialSpec(16, 16, True, True, 7), "W16A16"),
                          (SerialSpec(8, 8, False, True, 7), "W8A8 unsigned")):
            gemm_cases.append((f"edge M{m} 100->70 {tag}",
                               gemm_case(spec, m, 100, 70, scale_mul=40),
                               [("float", None)] + rq_modes,
                               [("float", None)] + k4_rq))
    for name, c, k3_modes, k4_modes in gemm_cases:
        for out, rq in k3_modes:
            kw = dict(spec=c["spec"], k=c["k"], relu=rq is not None,
                      requant=rq, requant_scale=None if rq is None else rs,
                      emit_packed=out == "packed")
            check_equal("K3", f"{name} {out}",
                        km.bitserial_matmul_v2_cuda(c["xp"], c["wp"],
                                                    c["scale"], c["bias"],
                                                    **kw),
                        km.bitserial_matmul_v2_ref(c["xp"], c["wp"],
                                                   c["scale"], c["bias"],
                                                   **kw))
        for out, rq in k4_modes:
            kw = dict(spec=c["spec"], k=c["k"], relu=False, requant=rq,
                      out_dtype=torch.bfloat16 if rq else torch.float32)
            tag = "" if rq is None else f" {rq.bits}b"
            check_equal("K4", f"{name} {out}{tag}",
                        km.bitserial_matmul_cuda(c["xc"], c["wp"],
                                                 c["scale"], c["bias"], **kw),
                        km.bitserial_matmul_ref(c["xc"], c["wp"], c["scale"],
                                                c["bias"], **kw))

    # ---------------------------------------------------- 8. the LM slice
    log("LM slice: Server(stablelm-1.6b FULL, batch_slots=4, max_len=64, "
        "seed=0) on the card, W4A8, bf16")
    t0 = time.perf_counter()
    lm = Server(lm_cfg, batch_slots=4, max_len=LM_MAX_LEN, seed=0)
    torch.cuda.synchronize()
    record["lm_init_s"] = time.perf_counter() - t0
    log(f"  {lm_cfg.n_layers} layers, random weights packed in "
        f"{record['lm_init_s']:.2f} s; device memory "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB")
    prompt_rng = np.random.RandomState(0)
    prompts = [prompt_rng.randint(0, lm_cfg.vocab_size, (n,)).astype(np.int32)
               for n in LM_PROMPTS]

    def lm_requests(idx=range(len(LM_PROMPTS))):
        return [GenRequest(prompts[i].copy(), LM_NEW) for i in idx]

    def lm_drive(server, requests):
        reset_counts()
        out = server.generate(requests)
        torch.cuda.synchronize()
        return [r.out_tokens for r in out], server.last_logits.clone(), counts()

    # per step: 7 projections a layer (K3 or K4), 4 distinct activations
    # (K1: q/k/v share one launch, gate/up another)
    per_step = 7 * lm_cfg.n_layers
    k1_per_step = len(K1_PER_LAYER) * lm_cfg.n_layers
    lm_k3 = lm_drive(lm, lm_requests())
    want = {"K1": k1_per_step * LM_NEW, "K2": 0, "K3": per_step * LM_NEW,
            "K4": 0}
    if lm_k3[2] != want:
        raise AssertionError(f"LM launches {lm_k3[2]}, want {want}")
    record["launches_lm_k3"] = lm_k3[2]
    log(f"  main path (K1 + K3): prefill + {LM_NEW - 1} decode steps, "
        f"launches {lm_k3[2]} = {k1_per_step} K1 and {per_step} K3 per step")
    toks, logits = lm_k3[0], lm_k3[1]
    if (logits.shape != (4, lm_cfg.vocab_size)
            or not bool(torch.isfinite(logits).all())
            or any(len(t) != LM_NEW or not all(0 <= v < lm_cfg.vocab_size
                                               for v in t) for t in toks)):
        raise AssertionError(f"bad LM output {logits.shape} {toks}")
    with torch.inference_mode():
        batch = {"tokens": torch.zeros((4, max(LM_PROMPTS)), dtype=torch.long,
                                       device=dev)}
        reset_counts()
        _, caches = transformer.prefill(lm.params, batch, lm.cfg,
                                        max_len=LM_MAX_LEN)
        c_pre = counts()
        reset_counts()
        transformer.decode_step(lm.params, caches, batch["tokens"][:, :1],
                                max(LM_PROMPTS), lm.cfg)
        c_dec = counts()
        torch.cuda.synchronize()
    if not (c_pre["K3"] == c_dec["K3"] == per_step
            and c_pre["K1"] == c_dec["K1"] == k1_per_step):
        raise AssertionError(f"per-step launches prefill {c_pre} decode "
                             f"{c_dec}, want {k1_per_step} K1 and {per_step} "
                             "K3")
    log(f"  one prefill: {c_pre}; one decode step: {c_dec}")
    plain_lm = Server(lm_cfg, lm.params, batch_slots=4, max_len=LM_MAX_LEN,
                      plain=True)
    t0 = time.perf_counter()
    lm_plain = lm_drive(plain_lm, lm_requests())
    record["lm_plain_generate_s"] = time.perf_counter() - t0
    if any(lm_plain[2].values()):
        raise AssertionError(f"plain run launched kernels: {lm_plain[2]}")
    if lm_plain[0] != toks or not torch.equal(lm_plain[1], logits):
        raise AssertionError("LM tokens/logits differ from the plain run")
    log(f"  tokens and last-step logits equal the plain run's "
        f"({record['lm_plain_generate_s']:.1f} s); request 0: {toks[0]}")
    k4_lm = Server(lm_cfg, lm.params, batch_slots=4, max_len=LM_MAX_LEN,
                   pack_acts=False)
    lm_k4 = lm_drive(k4_lm, lm_requests())
    want4 = {"K1": 0, "K2": 0, "K3": 0, "K4": per_step * LM_NEW}
    if lm_k4[2] != want4:
        raise AssertionError(f"K4 path launches {lm_k4[2]}, want {want4}")
    if lm_k4[0] != toks or not torch.equal(lm_k4[1], logits):
        raise AssertionError("pack_acts=False (K4) tokens/logits differ")
    record["launches_lm_k4"] = lm_k4[2]
    log(f"  pack_acts=False (K4): identical tokens and logits, launches "
        f"{lm_k4[2]}")
    two = Server(lm_cfg, lm.params, batch_slots=2, max_len=LM_MAX_LEN)
    one = Server(lm_cfg, lm.params, batch_slots=1, max_len=LM_MAX_LEN)
    t_two = two.generate(lm_requests([1]))[0].out_tokens
    t_one = one.generate(lm_requests([1]))[0].out_tokens
    if two.last_stats["padded_slots"] != 1 or t_two != t_one:
        raise AssertionError(f"dummy slot: {two.last_stats} {t_two} {t_one}")
    log(f"  batch_slots=2, one request (one dummy slot): tokens equal a "
        f"1-slot server's {t_two[:6]}...")
    record["lm_tokens"] = toks
    # the smoke config on the card agrees with the CPU's plain run, which
    # the CPU tests hold against the reference
    smoke = get_arch("stablelm-1.6b").smoke
    sm_gpu = Server(smoke, batch_slots=4, max_len=32, seed=0)
    sm_cpu = Server(smoke, tree_to(sm_gpu.params, "cpu"), batch_slots=4,
                    max_len=32, device="cpu")
    sm_prompts = [np.arange(n, dtype=np.int32) * 7 % smoke.vocab_size
                  for n in (3, 6, 9)]
    a = [r.out_tokens for r in sm_gpu.generate(
        [GenRequest(p.copy(), 8) for p in sm_prompts])]
    b = [r.out_tokens for r in sm_cpu.generate(
        [GenRequest(p.copy(), 8) for p in sm_prompts])]
    if a != b:
        raise AssertionError(f"smoke config: card {a} vs CPU {b}")
    log(f"  smoke config: card tokens equal the CPU plain run's {a[0]}")

    # ------------------------------------- 8b. the continuous LM engine
    log("LM engine: ContinuousLMEngine(stablelm-1.6b FULL, batch_slots=4, "
        "max_len=64, seed=0) on the card, its decode step one CUDA graph")
    from repro_torch.obs import Tracer
    from repro_torch.serving import ContinuousLMEngine

    def fenced_ms(fn, reps):
        """Median host wall of ``fn`` between two synchronizes."""
        out = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            out.append(time.perf_counter() - t0)
        return statistics.median(out) * 1e3

    def profile_counts(fn):
        """``fn`` once under the profiler: host wall, the card's busy time
        (its own events) and every device kernel's launches by name."""
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        busy, names = 0.0, {}
        for evt in prof.key_averages():
            if evt.device_type == DeviceType.CUDA:
                busy += evt.self_device_time_total / 1e3
                names[evt.key] = names.get(evt.key, 0) + evt.count
        if not names:
            raise AssertionError("the profiler recorded no device event")
        return {"wall_ms": wall * 1e3, "device_ms": busy, "launches": names}

    def by_kernel(launches):
        """K1, K3 and K4 launches among the profiler's kernel names (K3 and
        K4 are one template, told apart by its first argument)."""
        out = {"K1": 0, "K3": 0, "K4": 0}
        for name, n in launches.items():
            if "quantize_pack_kernel" in name:
                out["K1"] += n
            elif "bitserial_gemm_kernel<false" in name:
                out["K3"] += n
            elif "bitserial_gemm_kernel<true" in name:
                out["K4"] += n
        return out

    def cli_load(n, new_tokens=LM_NEW):
        """The reference CLI's mixed load (``launch/serve.py``): prompts of
        4-16 tokens from RandomState(0), every 4th request long."""
        rng = np.random.RandomState(0)
        m_long = max(1, min(new_tokens, LM_MAX_LEN - 16))
        return [GenRequest(
            rng.randint(0, lm_cfg.vocab_size,
                        (int(rng.randint(4, 17)),)).astype(np.int32),
            m_long if i % 4 == 0 else max(1, m_long // 4))
            for i in range(n)]

    def first_difference(got, want):
        for t, (a, b) in enumerate(zip(got, want)):
            if a != b:
                return f"token {t}: {a} vs {b}"
        return f"lengths {len(got)} vs {len(want)}"

    def parting_token(got, want):
        """The index of the first token where two runs part, or None."""
        for t, (a, b) in enumerate(zip(got, want)):
            if a != b:
                return t
        return None if len(got) == len(want) else min(len(got), len(want))

    def eager_alone(e, r):
        """Request ``r`` alone, eagerly, at engine ``e``'s shapes: its
        prompt right-padded to its bucket and prefilled with ``last_pos``,
        then decode steps over a ``batch_slots``-row cache that holds it in
        every row. Returns row 0's tokens, after checking that every row
        gave them, and per token the gap between the two largest logits it
        was chosen from."""
        n, b = len(r.prompt), e.batch_slots
        padded = np.zeros((1, executor.bucket_for(n, e.max_len)), np.int64)
        padded[0, :n] = r.prompt
        with torch.inference_mode():
            logits, pref = transformer.prefill(
                e.params, {"tokens": torch.from_numpy(padded).to(dev)},
                e.cfg, max_len=e.max_len,
                last_pos=torch.full((1,), n - 1, device=dev))
            caches = transformer.init_caches(e.cfg, b, e.max_len, device=dev)
            for c, p in zip(caches, pref):
                c["k"].copy_(p["k"].expand_as(c["k"]))
                c["v"].copy_(p["v"].expand_as(c["v"]))
            logits = logits.expand(b, -1)
            pos = torch.full((b,), n, dtype=torch.int32, device=dev)
            cols, gaps = [], []
            for t in range(r.max_new_tokens):
                top = torch.topk(logits[0].float(), 2).values
                gaps.append(top[0] - top[1])
                tok = torch.argmax(logits, -1).to(torch.int32)[:, None]
                cols.append(tok[:, 0])
                if t + 1 < r.max_new_tokens:
                    logits, _ = transformer.decode_step(e.params, caches,
                                                        tok, pos, e.cfg)
                    pos = pos + 1
            rows = torch.stack(cols, 1).cpu().tolist()
            gaps = torch.stack(gaps).cpu().tolist()
        if any(row != rows[0] for row in rows):
            raise AssertionError(f"the eager run's rows disagree: {rows}")
        return rows[0], gaps

    rec = {}
    t0 = time.perf_counter()
    eng = ContinuousLMEngine(lm_cfg, batch_slots=4, max_len=LM_MAX_LEN,
                             seed=0)
    torch.cuda.synchronize()
    rec["init_s"] = time.perf_counter() - t0
    warm = eng.warmup()
    st = eng.stats()
    rec.update(warmup_s=warm["seconds"], warmup_buckets=warm["buckets"],
               capture_s=st["capture_seconds"],
               step_launches=st["step_launches"])
    want_step = {"K1": k1_per_step, "K3": per_step, "K4": 0}
    if (not st["cuda_graph"] or st["compiles"]["decode"] != 1
            or st["step_launches"] != want_step):
        raise AssertionError(f"engine capture: graph {st['cuda_graph']}, "
                             f"compiles {st['compiles']}, launches at "
                             f"capture {st['step_launches']}, want "
                             f"{want_step}")
    log(f"  warmup {warm['seconds']:.2f} s (buckets {warm['buckets']}, "
        f"{warm['compiles']} compiles); decode step captured once in "
        f"{st['capture_seconds']:.3f} s with {st['step_launches']}")
    tracer = Tracer()
    eng.bind_runtime(None, None, tracer=tracer)   # one span per step
    load = cli_load(16)
    calls0 = st["calls"].get("decode", 0)
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = eng.serve(load)             # ends in the host copy of the tokens
    load_s = time.perf_counter() - t0
    c_load = counts()
    em = eng.engine_metrics()
    total_toks = sum(len(r.out_tokens) for r in out)
    # a replay calls no wrapper: the wrappers counted the 16 prefills
    want_load = {"K1": k1_per_step * len(load), "K2": 0,
                 "K3": per_step * len(load), "K4": 0}
    if c_load != want_load:
        raise AssertionError(f"engine load prefill launches {c_load}, want "
                             f"{want_load}")
    # what ran: the prefills, and the captured step once per replay
    ran_load = {k: c_load[k] + st["step_launches"][k] * em["decode_steps"]
                for k in ("K1", "K3")}
    st = eng.stats()
    if (st["recompiles_after_warmup"] != 0
            or st["calls"]["decode"] - calls0 != em["decode_steps"]):
        raise AssertionError(f"engine recompiled or skipped steps: {st}")
    steps_wall = sorted(sp.wall_us for sp in tracer.spans()
                        if sp.track == "lm-decode")
    if len(steps_wall) != em["decode_steps"]:
        raise AssertionError(f"{len(steps_wall)} step spans, "
                             f"{em['decode_steps']} steps")
    rec.update(load_requests=len(load), load_tokens=total_toks,
               load_s=load_s, tok_per_s=total_toks / load_s,
               decode_steps=em["decode_steps"],
               slot_occupancy=em["slot_occupancy"],
               launches_load_prefills=c_load, launches_load_run=ran_load,
               step_enqueue_ms_median=statistics.median(steps_wall) / 1e3,
               recompiles_after_warmup=st["recompiles_after_warmup"])
    log(f"  mixed load: {len(load)} requests, {total_toks} tokens in "
        f"{load_s * 1e3:.1f} ms = {rec['tok_per_s']:.1f} tok/s; "
        f"{em['decode_steps']} replayed steps (occupancy "
        f"{em['slot_occupancy']}), host time per step (enqueue, median) "
        f"{rec['step_enqueue_ms_median']:.3f} ms; launches run {ran_load} "
        f"(prefills {c_load}); recompiles_after_warmup 0")
    for r in out:
        if (len(r.out_tokens) != r.max_new_tokens
                or not all(0 <= v < lm_cfg.vocab_size for v in r.out_tokens)):
            raise AssertionError(f"bad engine output {r.out_tokens}")
    # every request equals its eager run alone at the engine's shapes
    alone = []
    for i, r in enumerate(out):
        ref, gaps = eager_alone(eng, r)
        alone.append((ref, gaps))
        if r.out_tokens != ref:
            raise AssertionError(
                f"engine request {i} (prompt {len(r.prompt)}, "
                f"{r.max_new_tokens} new) parts from its eager run alone at "
                f"{first_difference(r.out_tokens, ref)}")
    log(f"  every request's tokens equal its eager run alone at the "
        f"engine's shapes; request 0: {out[0].out_tokens}")
    # against a 1-slot eager Server (batch 1, the prompt unpadded): other
    # shapes, so the float parts may round otherwise; reported, with the
    # eager run's top-2 logit gap at the token where they part
    solo = Server(lm_cfg, eng.params, batch_slots=1, max_len=LM_MAX_LEN)
    parted = []
    for i, r in enumerate(out):
        ref = solo.generate([GenRequest(r.prompt.copy(),
                                        r.max_new_tokens)])[0].out_tokens
        t = parting_token(r.out_tokens, ref)
        if t is not None:
            parted.append({"request": i, "prompt": len(r.prompt),
                           "new": r.max_new_tokens, "token": t,
                           "engine": r.out_tokens[t],
                           "server": ref[t] if t < len(ref) else None,
                           "top2_logit_gap": alone[i][1][t]})
    rec["server_1slot"] = {"requests": len(out),
                           "equal": len(out) - len(parted),
                           "parted": parted}
    log(f"  against a 1-slot eager Server: {len(out) - len(parted)} of "
        f"{len(out)} requests equal; parted: {parted}")
    # the plain versions' engine (also captured) and the K4 path's, on the
    # first four requests
    four = [GenRequest(r.prompt.copy(), r.max_new_tokens) for r in out[:4]]
    plain_eng = ContinuousLMEngine(lm_cfg, eng.params, batch_slots=4,
                                   max_len=LM_MAX_LEN, plain=True)
    reset_counts()
    t0 = time.perf_counter()
    p_out = plain_eng.serve([GenRequest(r.prompt.copy(), r.max_new_tokens)
                             for r in four])
    rec["plain_serve_s"] = time.perf_counter() - t0
    if any(counts().values()) or not plain_eng.stats()["cuda_graph"]:
        raise AssertionError(f"plain engine: launches {counts()}, "
                             f"{plain_eng.stats()}")
    for i, r in enumerate(p_out):
        if r.out_tokens != out[i].out_tokens:
            raise AssertionError(
                f"plain engine request {i} parts at "
                f"{first_difference(out[i].out_tokens, r.out_tokens)}")
    del plain_eng
    k4_eng = ContinuousLMEngine(lm_cfg, eng.params, batch_slots=4,
                                max_len=LM_MAX_LEN, pack_acts=False)
    k4_eng.warmup()                   # the capture falls outside the count
    k4_step = k4_eng.stats()["step_launches"]
    reset_counts()
    k4_out = k4_eng.serve([GenRequest(r.prompt.copy(), r.max_new_tokens)
                           for r in four])
    c_k4 = counts()
    want_k4 = {"K1": 0, "K3": 0, "K4": per_step}
    if (k4_step != want_k4
            or c_k4 != {"K1": 0, "K2": 0, "K3": 0,
                        "K4": per_step * len(four)}):
        raise AssertionError(f"K4 engine: launches at capture {k4_step}, "
                             f"prefill launches in the serve {c_k4}")
    k4_prof = by_kernel(profile_counts(k4_eng._run_step)["launches"])
    if k4_prof != want_k4:
        raise AssertionError(f"the profiler saw {k4_prof} in one K4 replay, "
                             f"want {want_k4}")
    for i, r in enumerate(k4_out):
        ref = eager_alone(k4_eng, r)[0]
        if r.out_tokens != ref:
            raise AssertionError(
                f"K4 engine request {i} parts from its eager run alone at "
                f"{first_difference(r.out_tokens, ref)}")
    k4_run = c_k4["K4"] + k4_step["K4"] * k4_eng.decode_steps
    rec.update(k4_step_launches=k4_step, k4_replay_profile=k4_prof,
               launches_k4_serve_prefills=c_k4, launches_k4_serve_run=k4_run)
    log(f"  plain engine ({rec['plain_serve_s']:.1f} s) gives the engine's "
        f"tokens on the first four requests, and the K4 engine ({k4_step} "
        f"per captured step and per replay) its own eager run's")
    # the replayed step against the eager Server's decode step at batch 4,
    # host clock around synchronized work, then one replay under the
    # profiler
    toks_in = np.zeros((4, max(LM_PROMPTS)), np.int64)
    for i, pr in enumerate(prompts):
        toks_in[i, -len(pr):] = pr
    with torch.inference_mode():
        lg, caches = transformer.prefill(
            lm.params, {"tokens": torch.from_numpy(toks_in).to(dev)},
            lm.cfg, max_len=LM_MAX_LEN)
        tok = torch.argmax(lg, -1)[:, None]
        pos = iter(range(max(LM_PROMPTS), LM_MAX_LEN))
        def eager_step():
            transformer.decode_step(lm.params, caches, tok, next(pos),
                                    lm.cfg)

        rec["eager_step_ms"] = fenced_ms(eager_step, 15)
        eprof = profile_counts(eager_step)
    rec["profile_eager_step"] = {"wall_ms": eprof["wall_ms"],
                                 "device_ms": eprof["device_ms"],
                                 "kernels": sum(eprof["launches"].values())}
    # the arena as the load left it; its inactive rows stay frozen
    rec["replay_step_ms"] = fenced_ms(eng._run_step, 15)
    eng._run_step()
    prof = profile_counts(eng._run_step)
    rec["profile_replay"] = {"wall_ms": prof["wall_ms"],
                             "device_ms": prof["device_ms"],
                             "launches_by_kernel": by_kernel(
                                 prof["launches"]),
                             "kernels": sum(prof["launches"].values())}
    if by_kernel(prof["launches"]) != want_step:
        raise AssertionError(f"the profiler saw {by_kernel(prof['launches'])}"
                             f" in one replay, want {want_step}")
    ep = rec["profile_eager_step"]
    log(f"  decode step at batch 4 (median of 15, synchronized): replayed "
        f"graph {rec['replay_step_ms']:.3f} ms, eager Server "
        f"{rec['eager_step_ms']:.3f} ms; under the profiler, one replay: "
        f"wall {prof['wall_ms']:.3f} ms, device busy "
        f"{prof['device_ms']:.3f} ms, {rec['profile_replay']['kernels']} "
        f"kernels, of them {rec['profile_replay']['launches_by_kernel']}; "
        f"one eager step: wall {ep['wall_ms']:.3f} ms, busy "
        f"{ep['device_ms']:.3f} ms, {ep['kernels']} kernels")
    record["engine"] = rec

    # ------------------------------------------ 9. compiled gemm_packed
    g, calib = bench_graphs.tiny_mixed_cnn()
    tprog = compile_graph(g, calib, policy=QuantPolicy(
        mode="serial", w_bits=2, a_bits=2), device=dev)
    kinds = [st.kind for st in tprog.steps]
    xt = torch.from_numpy(np.random.RandomState(1).rand(3, 8, 8, 8).astype(
        np.float32)).to(dev)
    reset_counts()
    yt = tprog(xt)
    torch.cuda.synchronize()
    c_tiny = counts()
    if kinds[-1] != "gemm_packed" or c_tiny != {"K1": 2, "K2": 2, "K3": 1,
                                                "K4": 0}:
        raise AssertionError(f"tiny_mixed_cnn steps {kinds}, launches "
                             f"{c_tiny}")
    yp = executor.make_plain_runner(tprog)(tprog.params, xt)
    if yt.shape != (3, 10) or not torch.equal(yt, yp):
        raise AssertionError("tiny_mixed_cnn logits differ from the plain "
                             "runner")
    record["launches_tiny"] = c_tiny
    log(f"compiled tiny_mixed_cnn ({', '.join(kinds)}): launches {c_tiny}, "
        "logits equal the plain runner")

    # ------------------------------------------------------ 10. LM times
    log("LM GEMM times, W4A8 (ms, median, L2 flushed before each launch)")
    lm_rows = []
    for k, n in STABLELM_GEMMS:
        for m in (4, 4 * 16):
            c = gemm_case(w4a8, m, k, n, bias=False)
            ops = 2 * m * k * n
            wbytes = c["wp"].numel() * 4 + n * 4 + m * n * 4
            if m > 16:   # torch._int_mm's shape rule
                a8, b8 = c["xc"].to(torch.int8), c["wc"].to(torch.int8)
                lib, lib_name = (lambda: torch._int_mm(a8, b8)), "_int_mm"
            else:
                a16, b16 = c["xc"].half(), c["wc"].half()
                lib, lib_name = (lambda: torch.matmul(a16, b16)), "fp16 mm"
            lib_ms = timer(lib, 50)
            kw = dict(spec=w4a8, k=k)
            for kid, x, fk, fp in (
                    ("K3", c["xp"], km.bitserial_matmul_v2_cuda,
                     km.bitserial_matmul_v2_ref),
                    ("K4", c["xc"], km.bitserial_matmul_cuda,
                     km.bitserial_matmul_ref)):
                byt = x.numel() * 4 + wbytes
                call = lambda: fk(x, c["wp"], c["scale"], **kw)
                lm_rows.append({
                    "kernel": kid, "m": m, "k": k, "n": n,
                    "ms": timer(call, 50),
                    "plain_ms": timer(lambda: fp(x, c["wp"], c["scale"], **kw),
                                      5),
                    "library_ms": lib_ms, "library": lib_name,
                    "bound_ms": max(byt / HBM_BYTES_PER_S,
                                    ops / INT8_OPS_PER_S) * 1e3,
                    "bytes": byt, "ops": ops,
                    "bound_by": "bytes" if byt / HBM_BYTES_PER_S >=
                    ops / INT8_OPS_PER_S else "operations"})
    # K1 at the launches a layer makes (bf16, K1_PER_LAYER), at decode and
    # prefill rows, and at (1, 32), one warp's work: what any K1 call costs
    # whatever its size
    for m, k, g in [(m, k, g) for k, g in K1_PER_LAYER for m in (4, 4 * 16)
                    ] + [(1, 32, 1)]:
        xb = cuda(rng.standard_normal((m, k)).astype(np.float32)).bfloat16()
        steps = lm_steps[:g]
        byt, ops, bound = k1_bound(m, k, 8, 2, g)
        call = lambda: k1.quantize_pack_multi_cuda(xb, steps, lm_aspec)
        lm_rows.append({
            "kernel": "K1", "m": m, "k": k, "n": None, "g": g,
            "ms": timer(call, 50),
            "plain_ms": timer(lambda: k1.quantize_pack_multi_ref(
                xb, steps, lm_aspec), 10),
            "library_ms": None, "bound_ms": bound, "bytes": byt,
            "ops": ops, "bound_by": "bytes" if byt / HBM_BYTES_PER_S >=
            ops / FP32_OPS_PER_S else "operations"})
    for r in lm_rows:
        lib = "-" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
        what = f" G={r['g']}" if r["kernel"] == "K1" else f"->{r['n']}"
        log(f"  {r['kernel']} M{r['m']} {r['k']}{what}: kernel "
            f"{r['ms']:.4f}  plain {r['plain_ms']:.4f}  library {lib}  bound "
            f"{r['bound_ms']:.5f} ({r['bound_by']})")
    record["lm_calls"] = lm_rows
    # the least time of any launch under the same timer: one element zeroed
    elem = torch.zeros(1, device=dev)
    record["launch_floor_ms"] = timer(lambda: elem.zero_(), 50)
    log(f"  launch floor (t.zero_() on one element): "
        f"{record['launch_floor_ms']:.4f} ms")

    def lm_step(kid, key, m):
        """Sum over one LM step (24 layers) of a kernel's per-call number at
        M rows: K3 and K4 over the 7 projections of a layer, K1 over its 4
        launches (K1_PER_LAYER)."""
        if kid == "K1":
            calls = [(1, {"k": k, "g": g}) for k, g in K1_PER_LAYER]
        else:
            calls = [(c, {"k": k, "n": n}) for (k, n), c in
                     zip(STABLELM_GEMMS, GEMMS_PER_LAYER)]
        total_ = 0.0
        for c, want in calls:
            (row,) = [r for r in lm_rows if r["kernel"] == kid and
                      r["m"] == m and all(r[f] == v for f, v in want.items())]
            if row[key] is None:
                return None
            total_ += c * row[key]
        return lm_cfg.n_layers * total_

    # each GEMM kernel's sum over one decode step (M = 4) and one prefill
    # (M = 64), beside its bound and the library call's sum
    record["lm_step_sums"] = {}
    for kid in ("K1", "K3", "K4"):
        n_calls = k1_per_step if kid == "K1" else per_step
        for m, what in ((4, "decode step"), (64, "prefill")):
            sums = {key: lm_step(kid, key, m) for key in
                    ("ms", "bound_ms", "library_ms", "plain_ms")}
            record["lm_step_sums"][f"{kid} M{m}"] = sums
            lib = ("-" if sums["library_ms"] is None
                   else f"{sums['library_ms']:.4f}")
            log(f"  {kid} summed over one {what} ({n_calls} calls at M = "
                f"{m}): {sums['ms']:.4f} ms, bound {sums['bound_ms']:.4f}, "
                f"library {lib}, plain {sums['plain_ms']:.3f}")

    # the step and the end-to-end numbers of each LM path (K1 + K3, and K4
    # with pack_acts=False), host clock around synced work
    toks_in = np.zeros((4, max(LM_PROMPTS)), np.int64)
    for i, pr in enumerate(prompts):
        toks_in[i, -len(pr):] = pr
    batch = {"tokens": torch.from_numpy(toks_in).to(dev)}

    def walls(fn, reps):
        out = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            out.append(time.perf_counter() - t0)
        return statistics.median(out) * 1e3

    def lm_path_times(server, tag):
        """Prefill, decode step (median), generate's tokens/s (best of 2)
        and a profiler breakdown of one prefill and one decode step, into
        record."""
        def prefill():
            return transformer.prefill(server.params, batch, server.cfg,
                                       max_len=LM_MAX_LEN)

        with torch.inference_mode():
            record[f"{tag}_prefill_ms"] = walls(prefill, 5)
            record[f"{tag}_profile_prefill"] = device_profile(prefill)
            lg, caches = prefill()
            tok = torch.argmax(lg, -1)[:, None]
            pos = iter(range(max(LM_PROMPTS), LM_MAX_LEN))

            def step():
                transformer.decode_step(server.params, caches, tok, next(pos),
                                        server.cfg)

            record[f"{tag}_decode_step_ms"] = walls(step, 15)
            prof = device_profile(step)
        record[f"{tag}_profile_decode_step"] = prof
        gen_walls = []
        for _ in range(2):
            t0 = time.perf_counter()
            server.generate(lm_requests())
            gen_walls.append(time.perf_counter() - t0)
        record[f"{tag}_generate_s"] = min(gen_walls)
        record[f"{tag}_tok_per_s"] = 4 * LM_NEW / record[f"{tag}_generate_s"]
        log(f"{tag} batch 4: prefill ({max(LM_PROMPTS)} tokens) "
            f"{record[f'{tag}_prefill_ms']:.3f} ms, decode step "
            f"{record[f'{tag}_decode_step_ms']:.3f} ms, generate({LM_NEW} "
            f"new) {record[f'{tag}_generate_s'] * 1e3:.1f} ms = "
            f"{record[f'{tag}_tok_per_s']:.1f} tok/s")
        for what in ("prefill", "decode_step"):
            pr = record[f"{tag}_profile_{what}"]
            log(f"  profile of one {what}: wall {pr['wall_ms']:.3f} ms, "
                f"device busy {pr['device_ms']:.3f} ms (all profiler rows "
                f"{pr['all_rows_ms']:.3f}); K1 {pr['K1_ms']:.4f} ms in "
                f"{pr['K1_launches']:.0f} launches")
        for k, v in prof["by_name_ms"].items():
            log(f"  {v:9.4f} ms  {prof['launches'][k]:5.0f}x  {k[:80]}")

    lm_path_times(lm, "lm")       # K1 + K3 (pack_acts, the default)
    lm_path_times(k4_lm, "lm_k4")  # K4 (pack_acts=False)
    # the profiler counts the launches the wrappers counted
    for tag, k1_want in (("lm", k1_per_step), ("lm_k4", 0)):
        for what in ("prefill", "decode_step"):
            got = record[f"{tag}_profile_{what}"]["K1_launches"]
            if got != k1_want:
                raise AssertionError(f"{tag} {what}: the profiler saw {got} "
                                     f"K1 launches, want {k1_want}")

    def total(kid, key):
        vals = [r[key] for r in rows if r["kernel"] == kid]
        return None if any(v is None for v in vals) else sum(vals)

    def lm_bound_by(kid):
        byt, ops = lm_step(kid, "bytes", 4), lm_step(kid, "ops", 4)
        return ("bytes" if byt / HBM_BYTES_PER_S >= ops / INT8_OPS_PER_S
                else "operations")

    # ms, plain_ms, bound_ms, library_ms: the sum over one ResNet9 batch-32
    # forward (K1, K2) plus one LM decode step at batch 4 (K1, K3, K4); K1's
    # in_path_* are the profiler's, in one LM decode step and one prefill
    dec, pre = record["lm_profile_decode_step"], record["lm_profile_prefill"]
    line = {"kernels": [
        {"name": "quantize_pack (K1: ResNet9 quantize_pack + 2x pack_codes, "
                 "LM 4 per layer: one per distinct activation)",
         "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/quantize_pack.cu",
         "replaces": "src/repro/kernels/quantize_pack.py:53",
         "launches": (launches["K1"] + lm_k3[2]["K1"] + c_tiny["K1"]
                      + ran_load["K1"]),
         "engine_launches_per_captured_step": rec["step_launches"]["K1"],
         "max_abs_err": max_err["K1"],
         "ms": total("K1", "ms") + lm_step("K1", "ms", 4),
         "plain_ms": total("K1", "plain_ms") + lm_step("K1", "plain_ms", 4),
         "bound_ms": total("K1", "bound_ms") + lm_step("K1", "bound_ms", 4),
         "bound_by": "bytes", "library_ms": None,
         "in_path_ms_decode_step": dec["K1_ms"],
         "in_path_launches_decode_step": dec["K1_launches"],
         "in_path_ms_prefill": pre["K1_ms"],
         "in_path_launches_prefill": pre["K1_launches"]},
        {"name": "bitserial_conv2d (K2: ResNet9 conv1..conv8)",
         "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/bitserial_conv.cu",
         "replaces": "src/repro/kernels/bitserial_conv.py:153",
         "launches": launches["K2"] + c_tiny["K2"],
         "max_abs_err": max_err["K2"],
         "ms": total("K2", "ms"), "plain_ms": total("K2", "plain_ms"),
         "bound_ms": total("K2", "bound_ms"), "bound_by": "operations",
         "library_ms": total("K2", "library_ms")},
        {"name": "bitserial_matmul_v2 (K3: one LM decode step's packed GEMMs)",
         "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/bitserial_matmul.cu",
         "replaces": "src/repro/kernels/bitserial_matmul.py:380",
         "launches": lm_k3[2]["K3"] + c_tiny["K3"] + ran_load["K3"],
         "engine_launches_per_captured_step": rec["step_launches"]["K3"],
         "max_abs_err": max_err["K3"],
         "ms": lm_step("K3", "ms", 4), "plain_ms": lm_step("K3", "plain_ms", 4),
         "bound_ms": lm_step("K3", "bound_ms", 4), "bound_by": lm_bound_by("K3"),
         "library_ms": lm_step("K3", "library_ms", 4)},
        {"name": "bitserial_matmul (K4: one LM decode step's code GEMMs)",
         "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/bitserial_matmul.cu",
         "replaces": "src/repro/kernels/bitserial_matmul.py:171",
         "launches": lm_k4[2]["K4"] + k4_run,
         "engine_launches_per_captured_step": k4_step["K4"],
         "max_abs_err": max_err["K4"],
         "ms": lm_step("K4", "ms", 4), "plain_ms": lm_step("K4", "plain_ms", 4),
         "bound_ms": lm_step("K4", "bound_ms", 4), "bound_by": lm_bound_by("K4"),
         "library_ms": lm_step("K4", "library_ms", 4)},
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
