"""Every candidate tile of K2, K3 and K4 at the main paths' shapes: held
against the plain versions and timed on the card.

    PYTHONPATH=src python -m repro_torch.kernels.tile_sweep [--reps N]
    PYTHONPATH=src python -m repro_torch.kernels.tile_sweep --fit PATH

The shapes: ResNet9 W2A2's eight convs (each in its output mode on the
CNN path) at batch 1 and 32, and stablelm-1.6b W4A8's distinct
projections (K, N), read from its config, at M = 4, 256 and 32,768, for
K3 (packed activations) and K4 (int32 codes). For each shape every tile
of :func:`~repro_torch.kernels.tuning.tile_candidates` (or
``conv_tile_candidates``) must equal the plain version's output
(``torch.equal``), and ``kernels/timing.py``'s cold ``Timer`` gives each
tile's median ms. The full record (every tile's time, the heuristic's
and the cost model's choice) goes to ``chiprun_out/tile_sweep.json``;
standard output gets one line a shape and the card's name and power
limit. ``chip_smoke.py`` phase 22 runs the same checks (:func:`cases`,
:func:`check_tiles`) and times only the heuristic, the analytic choice and
the measured re-rank. Needs the card.

``--fit PATH`` (no card needed) fits the fitted fields of
:class:`~repro_torch.core.cost_model.H100Config` to such a record: least
squares on the log of every tile's modeled against its measured time
(:func:`fit`), then prints the constants and, per shape, the measured
time of the fitted model's choice against the heuristic's.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np
import torch

from repro_torch.core.bitserial import SerialSpec
from repro_torch.core.quant import QuantSpec, qrange
from repro_torch.kernels import bitserial_conv as k2
from repro_torch.kernels import bitserial_matmul as km
from repro_torch.kernels import tuning
from repro_torch.kernels.quantize_pack import pack_codes_ref

__all__ = ["RESNET9_CONVS", "W2A2", "W4A8", "LM_ROWS", "lm_projections",
           "cases", "check_tiles", "tile_of", "heuristic_point",
           "bad_tiles_raise", "main"]

W2A2 = SerialSpec(2, 2, True, True, 7)
W4A8 = SerialSpec(8, 4, True, True, 8)
# (name, c_in, c_out, stride, H_in, output mode) of ResNet9's conv1..conv8
RESNET9_CONVS = (
    ("conv1", 64, 64, 1, 32, "packed"), ("conv2", 64, 64, 1, 32, "packed"),
    ("conv3", 64, 128, 2, 32, "packed"),
    ("conv4", 128, 128, 1, 16, "codes"), ("conv5", 128, 256, 2, 8, "packed"),
    ("conv6", 256, 256, 1, 4, "codes"), ("conv7", 256, 512, 2, 2, "packed"),
    ("conv8", 512, 512, 1, 1, "float"))
CNN_BATCHES = (1, 32)
LM_ROWS = (4, 256, 32768)


def lm_projections(cfg):
    """The distinct (K, N) of a dense config's projections: q, k/v, o,
    gate/up, down."""
    hd = cfg.head_dim
    return sorted({(cfg.d_model, cfg.n_heads * hd),
                   (cfg.d_model, cfg.n_kv_heads * hd),
                   (cfg.n_heads * hd, cfg.d_model),
                   (cfg.d_model, cfg.d_ff), (cfg.d_ff, cfg.d_model)})


def _packed_weights(wc: torch.Tensor, bits: int) -> torch.Tensor:
    """(K, N) codes -> (bits, ceil(K/32), N) words."""
    return pack_codes_ref(wc.t().contiguous(), bits).permute(
        0, 2, 1).contiguous()


def cases(dev, rng, lm_cfg, *, batches=CNN_BATCHES, rows=LM_ROWS):
    """Yield ``(kid, label, cuda_fn, ref_fn, args, kw, candidates, shape)``
    for every shape: ``cuda_fn(*args, tile=..., **kw)`` launches the
    kernel, ``ref_fn`` is its plain version, ``candidates`` the tuner's
    ranked tiles (the analytic choice first), ``shape`` the tuner's key
    arguments. Operands are seeded random codes."""
    def cuda(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    for n in batches:
        for name, ci, co, stride, h, mode in RESNET9_CONVS:
            xc = cuda(rng.integers(-2, 2, (n * h * h, ci)).astype(np.int32))
            wc = cuda(rng.integers(-2, 2, (9 * co, ci)).astype(np.int32))
            xp = pack_codes_ref(xc, 2).reshape(2, n, h, h, -1).contiguous()
            wp = pack_codes_ref(wc, 2).reshape(2, 3, 3, co, -1).permute(
                0, 1, 2, 4, 3).contiguous()
            scale = cuda((rng.random(co) * 0.02 + 0.005).astype(np.float32))
            bias = cuda((rng.standard_normal(co) * 0.1).astype(np.float32))
            kw = dict(spec=W2A2, ci=ci, stride=stride, padding=1, relu=True)
            out_bits = None
            if mode != "float":
                kw.update(requant=QuantSpec(2, True),
                          requant_scale=torch.tensor(0.25, device=dev),
                          emit_packed=mode == "packed")
                out_bits = 2 if mode == "packed" else None
            shape = dict(n=n, h=h, w=h, ci=ci, co=co, fh=3, fw=3,
                         stride=stride, padding=1, spec=W2A2,
                         out_bits=out_bits)
            yield ("K2", f"{name} batch {n}", k2.bitserial_conv2d_cuda,
                   k2.bitserial_conv2d_ref, (xp, wp, scale, bias), kw,
                   tuning.conv_tile_candidates(**shape), shape)
    for k, nn in lm_projections(lm_cfg):
        wc = cuda(rng.integers(-8, 8, (k, nn)).astype(np.int32))
        wp = _packed_weights(wc, 4)
        scale = cuda((rng.random(nn) * 1e-3).astype(np.float32))
        del wc
        for m in rows:
            lo, hi = qrange(8, True)
            xc = cuda(rng.integers(lo, hi + 1, (m, k)).astype(np.int32))
            xp = pack_codes_ref(xc, 8)
            for kid, fn, ref, x, codes in (
                    ("K3", km.bitserial_matmul_v2_cuda,
                     km.bitserial_matmul_v2_ref, xp, False),
                    ("K4", km.bitserial_matmul_cuda, km.bitserial_matmul_ref,
                     xc, True)):
                shape = dict(m=m, k=k, n=nn, spec=W4A8, codes=codes)
                yield (kid, f"M={m} {k}->{nn}", fn, ref, (x, wp, scale),
                       dict(spec=W4A8, k=k),
                       tuning.tile_candidates(**shape), shape)
            del xc, xp


def tile_of(kid, nt, warps):
    """The tile object a kernel takes for ``(nt, warps)``."""
    return (tuning.ConvTileConfig if kid == "K2" else tuning.TileConfig)(
        8 * nt, warps)


def _point(tile):
    return tuple(tile.kernel_kwargs().values())


def check_tiles(kid, fn, ref, args, kw, cands):
    """Every candidate tile's output against the plain version's
    (``torch.equal``); returns the plain output. Raises on a difference."""
    want = ref(*args, **kw)
    for c in cands:
        got = fn(*args, tile=c, **kw)
        torch.cuda.synchronize()
        if got.shape != want.shape or not torch.equal(got, want):
            raise AssertionError(f"{kid} tile {_point(c)} differs from the "
                                 "plain version")
    return want


def bad_tiles_raise(dev):
    """Launch K2, K3 and K4 with tiles no instantiation takes (NT = 3;
    more warps than the launch bound; NT = 2 for a plan that runs
    ``Any``): each must raise at launch. Returns what each raised."""
    seen = []
    x = torch.zeros((8, 16, 2), dtype=torch.int32, device=dev)
    w = torch.zeros((4, 2, 64), dtype=torch.int32, device=dev)
    xa = torch.zeros((3, 16, 2), dtype=torch.int32, device=dev)
    wa = torch.zeros((3, 2, 64), dtype=torch.int32, device=dev)
    codes = torch.zeros((16, 64), dtype=torch.int32, device=dev)
    xc = torch.zeros((2, 1, 4, 4, 2), dtype=torch.int32, device=dev)
    wcv = torch.zeros((2, 3, 3, 2, 64), dtype=torch.int32, device=dev)
    one = torch.ones(64, device=dev)
    w3 = SerialSpec(3, 3, True, True, 7)
    launches = (
        ("K3 nt=3", lambda: km.bitserial_matmul_v2_cuda(
            x, w, one, spec=W4A8, k=64, tile=tile_of("K3", 3, 4))),
        ("K3 nt=4 warps=8", lambda: km.bitserial_matmul_v2_cuda(
            x, w, one, spec=W4A8, k=64, tile=tile_of("K3", 4, 8))),
        ("K3 nt=1 warps=33", lambda: km.bitserial_matmul_v2_cuda(
            x, w, one, spec=W4A8, k=64, tile=tile_of("K3", 1, 33))),
        ("K3 Any nt=2", lambda: km.bitserial_matmul_v2_cuda(
            xa, wa, one, spec=w3, k=64, tile=tile_of("K3", 2, 1))),
        ("K3 Any warps=9", lambda: km.bitserial_matmul_v2_cuda(
            xa, wa, one, spec=w3, k=64, tile=tile_of("K3", 1, 9))),
        ("K4 nt=2 warps=17", lambda: km.bitserial_matmul_cuda(
            codes, w, one, spec=W4A8, k=64, tile=tile_of("K4", 2, 17))),
        ("K4 warps=-1", lambda: km.bitserial_matmul_cuda(
            codes, w, one, spec=W4A8, k=64, tile=tile_of("K4", 1, -1))),
        ("K2 nt=8", lambda: k2.bitserial_conv2d_cuda(
            xc, wcv, one, spec=W2A2, ci=64, tile=tile_of("K2", 8, 1))),
        ("K2 nt=4 warps=5", lambda: k2.bitserial_conv2d_cuda(
            xc, wcv, one, spec=W2A2, ci=64, tile=tile_of("K2", 4, 5))))
    for what, launch in launches:
        try:
            launch()
        except RuntimeError as e:
            seen.append(f"{what}: {e}")
            continue
        raise AssertionError(f"{what}: launched a tile the kernel does not "
                             "take")
    torch.cuda.synchronize()
    return seen


def heuristic_point(kid, shape):
    if kid == "K2":
        s = {k: v for k, v in shape.items() if k != "out_bits"}
        return tuning.heuristic_conv_tile(**s)
    return tuning.heuristic_tile(shape["m"], shape["k"], shape["n"],
                                 shape["spec"])


FITTED = ("word_cycles", "issue_word", "issue_w_plane", "issue_a_plane",
          "issue_code", "block_cycles", "row_cycles", "l2_bw", "l1_bytes")


def _model_s(rec, nt, warps, h100):
    from repro_torch.core import cost_model
    key = dict(rec["key"])
    spec = W2A2 if rec["kernel"] == "K2" else W4A8
    bits = dict(a_bits=spec.a_bits, w_bits=spec.w_bits, nt=nt, warps=warps,
                h100=h100)
    if rec["kernel"] == "K2":
        return cost_model.conv_kernel_cost(
            key["n"], key["h"], key["w"], key["ci"], key["co"], fh=key["fh"],
            fw=key["fw"], stride=key["stride"], padding=key["padding"],
            out_bits=key["out_bits"], **bits)
    return cost_model.kernel_cost(key["m"], key["k"], key["n"],
                                  codes=key["codes"], **bits)


def fit(path):
    """Fit :data:`FITTED` to a sweep record; returns (the fitted
    ``H100Config``, per shape (label, heuristic ms, chosen ms))."""
    import dataclasses
    from scipy.optimize import least_squares
    from repro_torch.core.cost_model import H100Config
    with open(path) as f:
        records = json.load(f)["records"]
    base = H100Config()
    x0 = np.log([getattr(base, k) for k in FITTED])
    points = [(r, tuple(map(int, p.split(","))), t)
              for r in records for p, t in r["ms"].items()]

    def config(x):
        vals = {k: float(v) for k, v in zip(FITTED, np.exp(x))}
        vals["l1_bytes"] = int(vals["l1_bytes"])
        return dataclasses.replace(base, **vals)

    def resid(x):
        h = config(x)
        return [np.log(_model_s(r, nt, w, h) * 1e3 / t)
                for r, (nt, w), t in points]
    h = config(least_squares(resid, x0, method="trf").x)
    rows = []
    for r in records:
        best = min(r["ms"], key=lambda p: (
            _model_s(r, *map(int, p.split(",")), h), p))
        rows.append((f"{r['kernel']} {r['shape']}",
                     r["ms"][",".join(map(str, r["heuristic"]))],
                     r["ms"][best], best))
    return h, rows


def main(argv=None) -> int:
    import argparse
    from repro_torch.configs import get_arch
    from repro_torch.kernels import _build
    from repro_torch.kernels.timing import Timer

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--out", default="chiprun_out/tile_sweep.json")
    ap.add_argument("--fit", metavar="PATH",
                    help="fit the tile model to a sweep record and exit")
    args = ap.parse_args(argv)
    if args.fit:
        h, rows = fit(args.fit)
        print({k: getattr(h, k) for k in FITTED})
        for label, heur, chosen, point in rows:
            print(f"{label}: heuristic {heur:.4f} ms, the model's choice "
                  f"{point} {chosen:.4f} ms ({chosen / heur:.3f}x)")
        return 0
    if not torch.cuda.is_available():
        print("tile_sweep: needs a CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    _build.build_all([k2.KERNEL, km.KERNEL])
    regs = {k.name: [ln.strip() for ln in k.build_log().splitlines()
                     if "registers" in ln or "Compiling entry" in ln]
            for k in (k2.KERNEL, km.KERNEL)}
    timer = Timer(dev)
    rng = np.random.default_rng(22)
    records = []
    for kid, label, fn, ref, a, kw, cands, shape in cases(
            dev, rng, get_arch("stablelm-1.6b").full):
        check_tiles(kid, fn, ref, a, kw, cands)
        heur = heuristic_point(kid, shape)
        times = {}
        for c in cands:
            times[",".join(map(str, _point(c)))] = timer(
                lambda: fn(*a, tile=c, **kw), args.reps)
        t_none = timer(lambda: fn(*a, **kw), args.reps)
        best = min(times, key=times.get)
        rec = {"kernel": kid, "shape": label,
               "key": {k: (repr(v) if k == "spec" else v)
                       for k, v in shape.items()},
               "heuristic": list(heur), "heuristic_untiled_ms": t_none,
               "analytic": list(_point(cands[0])), "ms": times,
               "model_s": {",".join(map(str, _point(c))): c.cost
                           for c in cands},
               "fastest": best}
        records.append(rec)
        hk = ",".join(map(str, heur))
        print(f"{kid} {label}: {len(cands)} tiles equal the plain version; "
              f"heuristic {hk} {times[hk]:.4f} ms (untiled {t_none:.4f}), "
              f"analytic {rec['analytic']} "
              f"{times[','.join(map(str, rec['analytic']))]:.4f}, fastest "
              f"{best} {times[best]:.4f}", flush=True)
    print("bad tiles raise: " + "; ".join(bad_tiles_raise(dev)), flush=True)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"card": smi, "torch": torch.__version__,
                   "reps": args.reps, "registers": regs,
                   "records": records}, f, indent=1)
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
