"""The port's cost analysis (``repro_torch/launch/hlo_analysis.py``) on the
CPU: closed forms, the packed kernels as one op each (the plain versions
on the CPU and the shapes on ``meta`` give one record), collectives on a
fake (2, 2) mesh, the meta ``keep`` repair of ``init_placed_params``, the
dry run's new keys, and the stablelm-1.6b smoke config's three steps
against the reference's ``analyze_hlo`` run live on the same steps.

Every comparison is exact: the counts are sums of integers over shapes.

Why the reference's integer count equals 2·M·N·K (no digit factor): its
W4A8 ``qdense`` plans its digits with ``plan_spec``, which picks radix 8
for a signed 8-bit activation and a signed 4-bit weight, one digit each,
so each projection is one s32 ``dot`` of (M, K) x (K, N) in its optimized
HLO (seven a layer: q, k, v, o, gate, up, down), at prefill (M = 64) and
at decode (M = 4) alike. The port's kernels split each operand into
``kernel_digits`` = 1 digit too, so its ``flops_int`` equals its
``flops_logical`` integer part and the reference's ``flops_int``.
"""

import _torch_threads  # noqa: F401  (first: caps torch's threads under xdist)

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs import get_arch as j_get_arch
from repro.launch.hlo_analysis import analyze_hlo
from repro.models import transformer as jt
from repro.optim.optimizer import AdamWConfig as JAdamW
from repro.optim.optimizer import adamw_init as j_adamw_init
from repro.optim.optimizer import adamw_update as j_adamw_update

from repro_torch.configs import get_arch
from repro_torch.core.bitserial import SerialSpec
from repro_torch.core.quant import QuantSpec
from repro_torch.distributed.sharding import (local_slices, param_pspec,
                                              tree_paths)
from repro_torch.kernels import bitserial_conv, bitserial_matmul as km
from repro_torch.kernels import ops, quantize_pack
from repro_torch.launch import dryrun, hlo_analysis
from repro_torch.launch.hlo_analysis import CostMode, analyze
from repro_torch.launch.mesh import fake_mesh
from repro_torch.launch.train import init_placed_params, make_train_step
from repro_torch.models import transformer as tt
from repro_torch.optim import AdamWConfig, adamw_init

ARCH = "stablelm-1.6b"


# ------------------------------------------------------------ closed forms

def test_python_loop_flops_exact():
    """A 24-step layer loop is traced whole: 2·128·64·64 per step."""
    x = torch.randn(128, 64)
    ws = torch.randn(24, 64, 64)

    def f(x, ws):
        for w in ws:
            x = torch.tanh(x @ w)
        return x

    _, cost = analyze(f, x, ws)
    assert cost.flops == cost.flops_logical == 2 * 128 * 64 * 64 * 24
    assert cost.flops_int == 0
    assert cost.ops["aten.mm"] == 24


def test_checkpoint_counts_the_forward_twice():
    """``torch.utils.checkpoint`` recomputes its block in the backward: one
    more forward product than the same step without it."""
    x = torch.randn(32, 16, requires_grad=True)
    w = torch.randn(16, 16, requires_grad=True)

    def step(remat):
        def block(x):
            return torch.tanh(x @ w)
        y = (torch.utils.checkpoint.checkpoint(block, x, use_reentrant=False)
             if remat else block(x))
        return torch.autograd.grad(y.sum(), (x, w))

    fwd = 2 * 32 * 16 * 16
    _, plain = analyze(step, False)
    _, remat = analyze(step, True)
    assert plain.flops == 3 * fwd          # forward, dX, dW
    assert remat.flops == 4 * fwd          # the forward again


def test_int_mm_counts_as_integer():
    a = torch.randint(-128, 128, (32, 64), dtype=torch.int8)
    b = torch.randint(-128, 128, (64, 48), dtype=torch.int8)
    _, cost = analyze(torch._int_mm, a, b)
    assert cost.flops == cost.flops_int == 2 * 32 * 48 * 64


@pytest.mark.parametrize("how", ["slice", "index_put"])
def test_partial_write_charges_the_update(how):
    """A 4-row write into a (4096, 4096) float32 buffer (a KV-cache
    write) charges the update, not the buffer: the reference's
    dynamic-update-slice rule."""
    buf = torch.empty(4096, 4096, device="meta")
    upd = torch.empty(4, 4096, device="meta")
    rows = torch.arange(4, device="meta")

    def write():
        if how == "slice":
            buf[:4].copy_(upd)
        else:
            buf[rows] = upd

    _, cost = analyze(write)
    update = 4 * 4096 * 4
    assert update <= cost.bytes_hbm < 4096 * 4096 * 4
    if how == "slice":
        assert cost.bytes_hbm == update


def test_no_mode_no_report():
    """Outside a mode nothing is counted and the wrappers see no mode;
    modes nest; another thread sees none."""
    import threading
    assert hlo_analysis.ACTIVE.mode is None
    seen = []
    with CostMode() as outer:
        with CostMode() as inner:
            assert hlo_analysis.ACTIVE.mode is inner
            torch.ones(3) + 1
            t = threading.Thread(
                target=lambda: seen.append(hlo_analysis.ACTIVE.mode))
            t.start()
            t.join(10)
        assert hlo_analysis.ACTIVE.mode is outer
    assert hlo_analysis.ACTIVE.mode is None
    assert seen == [None]
    assert inner.cost.ops == {"aten.ones": 1, "aten.add": 1}


def test_no_mode_after_a_composite_op_in_inference_mode():
    """Under ``inference_mode`` a composite op reaches the mode whole and
    the mode enters itself again to decompose it; leaving it restores no
    mode (each entry's predecessor is kept, not the last one's)."""
    with torch.inference_mode():
        _, cost = analyze(torch.einsum, "ij,jk->ik", torch.ones(2, 3),
                          torch.ones(3, 4))
    assert hlo_analysis.ACTIVE.mode is None
    assert cost.flops == 2 * 2 * 3 * 4


# --------------------------------------------------------- kernels: one op

def _words(rng, *shape):
    return torch.from_numpy(rng.integers(-2**31, 2**31, shape,
                                         dtype=np.int64).astype(np.int32))


def _kernel_cases():
    """(kernel id, call, tensors, closed-form (flops_int, flops_logical))."""
    rng = np.random.default_rng(3)
    spec = SerialSpec(8, 4, True, True, 7)          # W4A8: 1 x 1 digits
    m, k, n = 5, 70, 40
    kw = -(-k // 32)
    scale = torch.from_numpy(rng.random(n).astype(np.float32))
    bias = torch.from_numpy(rng.random(n).astype(np.float32))
    xp, wp = _words(rng, 8, m, kw), _words(rng, 4, kw, n)
    codes = torch.from_numpy(rng.integers(-128, 128, (m, k)).astype(np.int32))
    gemm = (2.0 * m * n * k, 2.0 * m * n * k)
    cspec = SerialSpec(2, 2, True, True, 7)         # W2A2: 1 x 1 digits
    cn, h, ci, co = 2, 6, 40, 24
    cx, cw = _words(rng, 2, cn, h, h, 2), _words(rng, 2, 3, 3, 2, co)
    cscale = torch.from_numpy(rng.random(co).astype(np.float32))
    conv = (2.0 * cn * h * h * co * 9 * ci,) * 2
    e, c = 3, 4
    gx = torch.from_numpy(rng.integers(-128, 128, (e, c, k)).astype(np.int32))
    gw = _words(rng, e, 4, kw, n)
    rq = QuantSpec(4, True)
    return [
        ("K3", lambda a: km.bitserial_matmul_v2(
            a[0], a[1], a[2], a[3], spec=spec, k=k, relu=True, requant=rq,
            requant_scale=0.5, emit_packed=True), (xp, wp, scale, bias),
         gemm),
        ("K4", lambda a: ops.serial_matmul_op(
            a[0], a[1], a[2], a[3], spec=spec, k=k, out_dtype=torch.bfloat16),
         (codes, wp, scale, bias), gemm),
        ("K2", lambda a: bitserial_conv.bitserial_conv2d(
            a[0], a[1], a[2], spec=cspec, ci=ci, stride=1, padding=1,
            relu=True, requant=QuantSpec(2, True), requant_scale=0.25,
            emit_packed=True), (cx, cw, cscale), conv),
        ("K4g", lambda a: ops.serial_matmul_grouped_op(a[0], a[1], spec=spec,
                                                       k=k), (gx, gw),
         (2.0 * e * c * n * k,) * 2),
        ("K1", lambda a: ops.quantize_pack_activations_multi(
            a[0], [a[1], a[2]], QuantSpec(8, True)),
         (torch.randn(3, 5, 70, dtype=torch.bfloat16), torch.tensor(0.05),
          torch.tensor(0.02)), (0.0, 0.0)),
    ]


@pytest.mark.parametrize("case", range(5), ids=["K3", "K4", "K2", "K4g",
                                                "K1"])
def test_kernel_counts_as_one_op_on_cpu_and_meta(case):
    """One kernel call: the same record on the CPU (its plain version
    runs) and on ``meta`` (its output's shape), its FLOPs the closed form,
    its bytes the tensors in and out, no op beneath it counted."""
    kid, call, args, (fi, fl) = _kernel_cases()[case]
    before = ops.launch_counts()
    out_cpu, cpu = analyze(call, args)
    out_meta, meta = analyze(call, tuple(a.to("meta") for a in args))
    assert cpu.as_dict() == meta.as_dict()
    assert out_meta.is_meta and out_meta.shape == out_cpu.shape
    assert out_meta.dtype == out_cpu.dtype
    assert cpu.kernel_calls == dict(dict.fromkeys(hlo_analysis.KERNELS, 0),
                                    **{kid: 1})
    assert (cpu.flops_int, cpu.flops_logical, cpu.flops) == (fi, fl, fi)
    nbytes = sum(a.numel() * a.element_size() for a in args)
    # the ops outside the kernel: K4's reshapes, K1's over_rows views
    assert cpu.bytes_hbm == nbytes + out_cpu.numel() * out_cpu.element_size()
    assert all(k.startswith("aten.") for k in cpu.ops)
    assert not any(o in cpu.ops for o in ("aten.mm", "aten.bitwise_and",
                                          "aten.round", "aten.stack"))
    assert ops.launch_counts() == before     # nothing launched


def test_meta_kernel_outputs_are_shapes_only():
    """With no mode active a meta tensor reaches the kernel's output
    shape, not its plain version; a CPU tensor still runs the plain
    version."""
    rng = np.random.default_rng(4)
    x = torch.randn(7, 70)
    got = quantize_pack.quantize_pack(x.to("meta"), torch.tensor(0.05,
                                      device="meta"), QuantSpec(8, True))
    ref = quantize_pack.quantize_pack(x, torch.tensor(0.05),
                                      QuantSpec(8, True))
    assert got.is_meta and got.shape == ref.shape == (8, 7, 3)
    codes = torch.from_numpy(rng.integers(-8, 8, (6, 40)).astype(np.int32))
    assert ops.pack_activations(codes.to("meta"), 4).shape == (4, 6, 2)


def test_smoke_model_same_record_on_cpu_and_meta():
    """The packed prefill and decode of the smoke config (K1 + K3) and a
    train step: the CPU's record equals the meta device's, field for
    field (what ``chip_smoke.py`` phase 21 holds the card to)."""
    cfg = tt.serve_policy(get_arch(ARCH).smoke, pack_acts=True)
    rec = {}
    for dev in ("cpu", "meta"):
        gen = (dryrun._MetaGenerator() if dev == "meta"
               else torch.Generator().manual_seed(0))
        p = tt.init_params(gen, cfg, packed=True)
        toks = torch.zeros((2, 8), dtype=torch.int64, device=dev)
        with torch.inference_mode():
            (logits, caches), pre = analyze(tt.prefill, p, {"tokens": toks},
                                            cfg, max_len=12)
            _, dec = analyze(tt.decode_step, p, caches, toks[:, :1], 8, cfg)
        fp = tt.init_params(gen, cfg)
        step = make_train_step(cfg, AdamWConfig())
        _, tr = analyze(step, {"params": fp, "opt": adamw_init(fp)},
                        {"tokens": toks, "labels": toks})
        rec[dev] = [c.as_dict() for c in (pre, dec, tr)]
    assert rec["cpu"] == rec["meta"]
    pre, dec, _ = rec["cpu"]
    n = cfg.n_layers
    assert pre["kernel_calls"]["K1"] == dec["kernel_calls"]["K1"] == 4 * n
    assert pre["kernel_calls"]["K3"] == dec["kernel_calls"]["K3"] == 7 * n


def test_cnn_forward_same_record_on_cpu_and_meta():
    """ResNet9 W2A2's compiled Program, one batch-32 forward (host conv0,
    3 K1 + 8 K2): the CPU's record equals the meta device's, the host
    conv's channels-last output layout kept on ``meta`` as the CPU and
    cuDNN keep it (else a layout copy appears on ``meta`` alone)."""
    from repro_torch.compiler import executor
    from repro_torch.models import resnet
    rng = np.random.default_rng(7)
    prog = resnet.resnet9_compile(
        resnet.resnet9_init(0), rng.random((8, 32, 32, 3), dtype=np.float32),
        device="cpu")
    x = torch.from_numpy(rng.random((32, 32, 32, 3), dtype=np.float32))
    mparams = {k: {n: t.to("meta") for n, t in p.items()}
               for k, p in prog.params.items()}
    mx = x.to("meta")
    run = executor.make_runner(prog)
    with torch.inference_mode():
        out, cpu = analyze(run, prog.params, x)
        _, meta = analyze(run, mparams, mx)
    assert cpu.as_dict() == meta.as_dict()
    assert cpu.kernel_calls == dict(dict.fromkeys(hlo_analysis.KERNELS, 0),
                                    K1=3, K2=8)
    assert cpu.ops["aten.convolution"] == 1 and "aten.clone" not in cpu.ops
    assert 0 < cpu.flops - cpu.flops_int < cpu.flops_int


# ------------------------------------------------------------ collectives

def test_collectives_counted_per_iteration():
    """A fake (2, 2) mesh in this process: a 24-step loop with an
    all-reduce over ``data`` counts 24 all-reduces of 128 x 64 float32;
    the group is gone after the mesh closes, and a second mesh while one
    is open raises."""
    import torch.distributed._functional_collectives as funcol
    with fake_mesh((2, 2)) as mesh:
        assert mesh.mesh_dim_names == ("data", "model")
        with pytest.raises(RuntimeError, match="process group is open"):
            with fake_mesh((2, 2)):
                pass

        def f(x, ws):
            for w in ws:
                x = funcol.all_reduce(torch.tanh(x @ w), "sum", (mesh, 0))
            return x

        _, cost = analyze(f, torch.empty(128, 64, device="meta"),
                          torch.empty(24, 64, 64, device="meta"))
    assert not dist.is_initialized()
    assert cost.collective_counts["all-reduce"] == 24
    assert cost.collective_bytes["all-reduce"] == 24 * 128 * 64 * 4
    assert cost.total_collective_bytes == 24 * 128 * 64 * 4
    assert sum(cost.collective_counts.values()) == 24
    assert cost.flops == 2 * 128 * 64 * 64 * 24


def test_init_placed_params_on_meta():
    """``init_placed_params`` with the meta generator on a fake (2, 2)
    mesh: every leaf a DTensor of the unplaced draw's full shape, its
    local shard the shape ``param_pspec`` gives (each layer's leaves pass
    through ``keep`` on meta too; before, a ``KeyError``)."""
    from torch.distributed.tensor import DTensor
    cfg = get_arch(ARCH).smoke
    full = dict(tree_paths(tt.init_params(dryrun._MetaGenerator(), cfg)))
    with fake_mesh((2, 2)) as mesh:
        placed = dict(tree_paths(init_placed_params(dryrun._MetaGenerator(),
                                                    cfg, mesh)))
        assert placed.keys() == full.keys()
        split = 0
        for path, t in placed.items():
            assert isinstance(t, DTensor) and t.shape == full[path].shape
            shape = tuple(full[path].shape)
            want = tuple(len(range(shape[d])[s]) for d, s in enumerate(
                local_slices(param_pspec(path, shape, mesh), shape, mesh)))
            assert tuple(t.to_local().shape) == want, path
            split += want != shape
        assert split > 0


# ------------------------------------------------------------------ dry run

def test_dryrun_cells_carry_the_cost(tmp_path):
    """``run_cell`` on full-width stablelm at 1 layer: the train cell
    counted per device of the fake 16 x 16 mesh (all-gathers and
    all-reduces among its collectives), and so is the decode cell since
    the port serves a sharded packed model (the row-parallel projections'
    int32 sums and the embedding's rows all-reduced, the vocab-parallel
    logits all-gathered); so is mamba2's (an SSM, served on a mesh since
    its own slice: in_proj's output, the conv's and the heads' outputs
    all-gathered, out_proj's int32 sum all-reduced); qwen1.5-110b's train
    cell, whose 8 kv heads do not divide the model axis, counts too."""
    keys = ("flops", "flops_int", "flops_logical", "bytes_hbm",
            "collectives", "kernel_calls", "ops", "cost_mesh", "cost_s")
    tr = dryrun.run_cell(ARCH, "train_4k", n_layers=1, out_dir=str(tmp_path))
    assert all(k in tr for k in keys)
    assert tr["cost_mesh"] == {"data": 16, "model": 16}
    col = tr["collectives"]
    assert col["counts"]["all-gather"] > 0 and col["counts"]["all-reduce"] > 0
    assert col["total_bytes"] == sum(col["bytes"].values()) > 0
    assert tr["flops"] > 0 and tr["flops_int"] == 0
    assert tr["kernel_calls"] == dict.fromkeys(hlo_analysis.KERNELS, 0)
    de = dryrun.run_cell(ARCH, "decode_32k", n_layers=1,
                         out_dir=str(tmp_path))
    assert all(k in de for k in keys)
    assert de["cost_mesh"] == {"data": 16, "model": 16}
    assert "cost_mesh_reason" not in de
    col = de["collectives"]
    assert col["counts"]["all-reduce"] == 2 * 1 + 1
    assert col["counts"]["all-gather"] == 1
    assert de["kernel_calls"]["K1"] == 4 and de["kernel_calls"]["K3"] == 7
    assert 0 < de["flops_int"] < de["flops"]
    assert "a step on one device of a fake 16x16 mesh" in dryrun._line(de)
    ssm = dryrun.run_cell("mamba2-780m", "decode_32k", n_layers=1,
                          out_dir=str(tmp_path))
    assert ssm["cost_mesh"] == {"data": 16, "model": 16}
    assert "cost_mesh_reason" not in ssm
    assert ssm["collectives"]["counts"]["all-gather"] == 3
    assert ssm["collectives"]["counts"]["all-reduce"] == 1
    assert "a step on one device of a fake 16x16 mesh" in dryrun._line(ssm)
    # 8 kv heads over the 16-way model axis (placed.split_heads)
    qw = dryrun.run_cell("qwen1.5-110b", "train_4k", n_layers=1,
                         out_dir=str(tmp_path))
    assert "cost_error" not in qw and qw["flops"] > tr["flops"]
    assert not dist.is_initialized()


# ------------------------------------------------------ against the reference

# (M, the cache length) of the reference's serve steps in the module's
# docstring: decode at batch 4 against 64 slots, prefill of 4 x 16 tokens
# into 24
_DECODE = (4, 64)
_PREFILL = (4, 16, 24)


@pytest.fixture(scope="module")
def reference():
    """The reference's ``analyze_hlo`` of its three steps on the smoke
    config (``backend="xla"``), compiled from abstract inputs."""
    cfg = jt.serve_policy(j_get_arch(ARCH).smoke, backend="xla")
    params = jax.eval_shape(lambda: jt.init_params(jax.random.PRNGKey(0),
                                                   cfg))
    packed = jax.eval_shape(lambda p: jt.pack_params(p, cfg), params)
    b, slots = _DECODE
    caches = jax.eval_shape(lambda: jt.init_caches(cfg, b, slots))
    tok = jax.ShapeDtypeStruct((b, 1), jnp.int32)

    def cost(fn, *args):
        return analyze_hlo(jax.jit(fn).lower(*args).compile().as_text())

    out = {"decode": cost(lambda p, c, t: jt.decode_step(
        p, c, t, jnp.int32(slots - 1), cfg), packed, caches, tok)}
    bp, s, max_len = _PREFILL
    toks = {"tokens": jax.ShapeDtypeStruct((bp, s), jnp.int32)}
    out["prefill"] = cost(lambda p, x: jt.prefill(p, x, cfg, max_len=max_len),
                          packed, toks)
    tcfg = dataclasses.replace(cfg, remat_policy="nothing")

    def step(p, o, x):
        (_, _), g = jax.value_and_grad(jt.loss_fn, has_aux=True)(p, x, tcfg)
        return j_adamw_update(p, g, o, JAdamW())

    out["train"] = cost(step, params, jax.eval_shape(j_adamw_init, params),
                        {"tokens": toks["tokens"], "labels": toks["tokens"]})
    return out


def _port_costs():
    cfg = tt.serve_policy(get_arch(ARCH).smoke, pack_acts=False)
    gen = dryrun._MetaGenerator()
    packed = tt.init_params(gen, cfg, packed=True)
    b, slots = _DECODE
    bp, s, max_len = _PREFILL
    toks = torch.empty((bp, s), dtype=torch.int64, device="meta")
    with torch.inference_mode():
        caches = tt.init_caches(cfg, b, slots, device="meta")
        tok = torch.empty((b, 1), dtype=torch.int64, device="meta")
        _, dec = analyze(tt.decode_step, packed, caches, tok, slots - 1, cfg)
        _, pre = analyze(tt.prefill, packed, {"tokens": toks}, cfg,
                         max_len=max_len)
    params = tt.init_params(gen, dataclasses.replace(cfg,
                                                     remat_policy="nothing"))
    step = make_train_step(cfg, AdamWConfig())
    _, tr = analyze(step, {"params": params, "opt": adamw_init(params)},
                    {"tokens": toks, "labels": toks})
    return cfg, {"decode": dec, "prefill": pre, "train": tr}


def _projection_kn(cfg) -> int:
    """Sum of K·N over one layer's seven projections."""
    d, f = cfg.d_model, cfg.d_ff
    q = cfg.n_heads * cfg.head_dim
    kv = cfg.n_kv_heads * cfg.head_dim
    return d * q + 2 * d * kv + q * d + 2 * d * f + f * d


def test_float_flops_equal_reference(reference):
    """Float FLOPs (``flops - flops_int``) equal the reference's exactly at
    decode (the head, QK and PV over 64 slots: 393,216), prefill (the last
    position's head and attention over 24 slots: 1,048,576) and the train
    step (45,613,056)."""
    _, port = _port_costs()
    got = {k: c.flops - c.flops_int for k, c in port.items()}
    want = {k: c.flops - c.flops_int for k, c in reference.items()}
    assert got == want
    assert want["decode"] == 393_216 and want["prefill"] == 1_048_576
    assert want["train"] == 45_613_056
    assert port["train"].flops_int == reference["train"].flops_int == 0


def test_integer_flops_closed_form(reference):
    """The integer part: ``flops_logical``'s is 2·M·ΣK·N over the layers'
    projections; the port's ``flops_int`` (1 x 1 digits at W4A8) and the
    reference's (one s32 dot a projection, radix 8 by ``plan_spec``, see
    the module's docstring) equal it."""
    cfg, port = _port_costs()
    kn = _projection_kn(cfg) * cfg.n_layers
    for step, m in (("decode", _DECODE[0]),
                    ("prefill", _PREFILL[0] * _PREFILL[1])):
        c = port[step]
        float_part = c.flops - c.flops_int
        assert c.flops_logical - float_part == 2 * m * kn
        assert c.flops_int == 2 * m * kn == reference[step].flops_int
        assert c.kernel_calls["K4"] == 7 * cfg.n_layers
    assert reference["prefill"].flops_int == 10_485_760
    assert reference["decode"].flops_int == 655_360
