"""Cost-model-driven tile autotuner for the int8 tensor-core kernels K2,
K3 and K4 (``kernels/csrc/digits.cuh``).

Counterpart of ``repro/kernels/tuning.py``. The reference tunes the
Pallas kernels' VMEM blocks; here the degrees of freedom are what the CUDA
kernels take at launch: rows (K3, K4) or output pixels (K2) per block,
8 NT for NT = 1, 2 or 4 row tiles of the instantiation (1 only for a plan
that runs ``Any``), and the K-split warps of a block, 1 to the
instantiation's launch bound. The column tile stays 32, one packed output
word. This module enumerates the candidate tiles of a shape (every NT up
to the first that covers the rows, warps in powers of two up to the first
that covers the K words, and always the kernels' own heuristic tile,
:func:`heuristic_tile`), drops those over the shared-memory budget or the
launch bound, scores the rest with :mod:`repro_torch.core.cost_model`'s
H100 tile model and picks the cheapest, keeping the heuristic's tile
unless the model predicts a gain of at least :data:`KEEP_MARGIN`.

Selection is pure arithmetic (no torch, no device), deterministic, and
memoized in a bounded, thread-safe LRU (L1), so a serving loop pays the
enumeration once per (shape, plans, output format) and every later call
is a dict hit. :func:`set_persistent_store` attaches an
:class:`~repro_torch.compiler.artifact.ArtifactStore` as L2: every
decision is persisted under the store's ``tuning/`` (kinds ``tile``,
``conv_tile``, ``tile_measured``, ``conv_tile_measured``), so a restarted
process re-enumerates nothing; ``cache_info()["enumerations"]`` counts
the enumerations actually run, the counter warm-boot tests hold at zero.
A record that does not decode is re-tuned.

A tile changes nothing in the result: the integer sums are exact under any
K split, so every tile gives the plain version's output bit for bit.
"""

from __future__ import annotations

import collections
import dataclasses
import threading
from typing import Optional, Tuple

from repro_torch.core import cost_model
from repro_torch.core.cost_model import (H100Config, conv_kernel_cost,
                                         conv_kernel_smem_bytes, fixed_plans,
                                         kernel_cost, kernel_smem_bytes,
                                         launch_bound_threads, max_warps)

__all__ = ["TileConfig", "ConvTileConfig", "HEURISTIC", "launch_args",
           "heuristic_tile", "heuristic_conv_tile", "tile_candidates",
           "conv_tile_candidates", "choose_tile", "choose_tile_measured",
           "choose_conv_tile", "choose_conv_tile_measured", "clear_cache",
           "cache_info", "set_cache_limit", "set_persistent_store",
           "KEEP_MARGIN"]


def _nt(block: int) -> int:
    if block % 8:
        raise ValueError(f"a block of {block} rows is not whole row tiles "
                         "of 8")
    return block // 8


@dataclasses.dataclass(frozen=True)
class TileConfig:
    """One K3/K4 tile: ``block_m`` rows per block (8 NT) and ``warps``
    K-split warps; 0 for both is the kernels' own heuristic
    (:data:`HEURISTIC`)."""

    block_m: int
    warps: int
    cost: float = 0.0          # modeled seconds/launch (diagnostic)
    smem_bytes: int = 0        # static shared memory of a block

    def kernel_kwargs(self) -> dict:
        """The C entry's tile arguments: ``nt`` row tiles, ``warps``."""
        return {"nt": _nt(self.block_m), "warps": self.warps}


@dataclasses.dataclass(frozen=True)
class ConvTileConfig:
    """One K2 tile: ``block_p`` output pixels per block (8 NT) and
    ``warps`` K-split warps."""

    block_p: int
    warps: int
    cost: float = 0.0
    smem_bytes: int = 0

    def kernel_kwargs(self) -> dict:
        return {"nt": _nt(self.block_p), "warps": self.warps}


#: the kernels' own choice (``digits.cuh``'s ``nt_for``/``warps_for``),
#: for either kind: what a step with no tuned tile launches
HEURISTIC = TileConfig(0, 0)


def launch_args(tile) -> Tuple[int, int]:
    """``(nt, warps)`` for a C entry: ``(0, 0)`` (the heuristic) for
    None."""
    if tile is None:
        return 0, 0
    kw = tile.kernel_kwargs()
    return int(kw["nt"]), int(kw["warps"])


# --------------------------------------------------------------------------
# the kernels' heuristic (digits.cuh: nt_for, warps_for), mirrored
# --------------------------------------------------------------------------

_WORDS_PER_WARP = 4    # kWordsPerWarp
_MAX_NT = 4            # kMaxNT
_BLOCKS = 264          # kBlocks: blocks a shape should give before NT halves


def _heuristic(rows: int, cols: int, words: int, fixed: bool):
    nt = _MAX_NT if fixed else 1
    col_blocks = -(-cols // 32)
    while nt > 1 and (8 * nt // 2 >= rows
                      or col_blocks * -(-rows // (8 * nt)) < _BLOCKS):
        nt //= 2
    warps = min(max(1, -(-words // _WORDS_PER_WARP)), max_warps(fixed, nt))
    return nt, warps


def _fixed(spec) -> bool:
    return fixed_plans(spec.a_bits, spec.w_bits, spec.a_signed,
                       spec.w_signed)


def heuristic_tile(m: int, k: int, n: int, spec) -> Tuple[int, int]:
    """``(nt, warps)`` the K3/K4 C entry picks for this shape when given
    none."""
    return _heuristic(m, n, -(-k // 32), _fixed(spec))


def _conv_rows_words(n, h, w, ci, fh, fw, stride, padding):
    ho = (h + 2 * padding - fh) // stride + 1
    wo = (w + 2 * padding - fw) // stride + 1
    return n * ho * wo, fh * fw * (-(-ci // 32))


def heuristic_conv_tile(n: int, h: int, w: int, ci: int, co: int, *,
                        fh: int, fw: int, stride: int, padding: int,
                        spec) -> Tuple[int, int]:
    """``(nt, warps)`` the K2 C entry picks when given none."""
    rows, words = _conv_rows_words(n, h, w, ci, fh, fw, stride, padding)
    return _heuristic(rows, co, words, _fixed(spec))


# --------------------------------------------------------------------------
# the L1 LRU and the persistent L2
# --------------------------------------------------------------------------

# Bounded LRU: a long-lived service facing churning shapes (each new
# (shape, plans) is one entry) must not grow this without bound; re-tuning
# an evicted key is arithmetic (~ms), so a modest cap costs only the rare
# cold re-enumeration.
_CACHE_LIMIT_DEFAULT = 4096
_cache: "collections.OrderedDict" = collections.OrderedDict()
_cache_lock = threading.Lock()
_cache_limit = _CACHE_LIMIT_DEFAULT
_cache_stats = {"hits": 0, "misses": 0, "evictions": 0,
                "persist_hits": 0, "persist_errors": 0, "enumerations": 0}
_persist = None        # the L2 store (set_persistent_store)


def set_persistent_store(store):
    """Attach (or with None detach) a persistent L2: an
    :class:`~repro_torch.compiler.artifact.ArtifactStore`, or anything with
    its ``tuning_get``/``tuning_put``. Returns the previous one."""
    global _persist
    with _cache_lock:
        old, _persist = _persist, store
    return old


def _persist_lookup(key, cls):
    """L2: the decision persisted for ``key``, or None (absent, or a
    record that does not decode: re-tuned)."""
    with _cache_lock:
        store = _persist
    if store is None:
        return None
    rec = store.tuning_get(repr(key))
    if rec is None:
        return None
    try:
        cfg = cls(**rec["config"])
        _nt(cfg.block_m if cls is TileConfig else cfg.block_p)
    except (KeyError, TypeError, ValueError, AttributeError):
        return None
    with _cache_lock:
        _cache_stats["persist_hits"] += 1
    return cfg


def _persist_record(key, kind, cfg) -> None:
    with _cache_lock:
        store = _persist
        _cache_stats["enumerations"] += 1
    if store is None:
        return
    try:
        store.tuning_put(repr(key), kind, dataclasses.asdict(cfg))
    except OSError:
        # a store whose directory went away or filled up: the decision
        # still holds in L1; the next process tunes it again
        with _cache_lock:
            _cache_stats["persist_errors"] += 1


def _cache_get(key):
    with _cache_lock:
        hit = _cache.get(key)
        if hit is not None:
            _cache.move_to_end(key)
            _cache_stats["hits"] += 1
        else:
            _cache_stats["misses"] += 1
        return hit


def _cache_put(key, value) -> None:
    with _cache_lock:
        _cache[key] = value
        _cache.move_to_end(key)
        while len(_cache) > _cache_limit:
            _cache.popitem(last=False)
            _cache_stats["evictions"] += 1


def set_cache_limit(limit: int) -> int:
    """Resize the L1 (evicting the LRU overflow); returns the old limit."""
    global _cache_limit
    if limit < 1:
        raise ValueError(f"cache limit must be >= 1, got {limit}")
    with _cache_lock:
        old, _cache_limit = _cache_limit, limit
        while len(_cache) > _cache_limit:
            _cache.popitem(last=False)
            _cache_stats["evictions"] += 1
    return old


def clear_cache() -> None:
    """Empty the L1 and zero the counters (a restarted process's state)."""
    with _cache_lock:
        _cache.clear()
        for k in _cache_stats:
            _cache_stats[k] = 0


def cache_info() -> dict:
    with _cache_lock:
        return {"entries": len(_cache), "limit": _cache_limit,
                "persistent_store": _persist is not None, **_cache_stats}


_H100 = H100Config()
_H100_KEY = repr(_H100)


def _card(h100: H100Config) -> str:
    """The card's part of a key: its config's repr (a fitted constant
    changed re-tunes), computed once for the default config, which every
    call on the serving path uses."""
    return _H100_KEY if h100 is _H100 else repr(h100)


def _memoized(key, cls, kind, tune):
    hit = _cache_get(key)
    if hit is not None:
        return hit
    cfg = _persist_lookup(key, cls)
    if cfg is None:
        cfg = tune()
        _persist_record(key, kind, cfg)
    _cache_put(key, cfg)
    return cfg


# --------------------------------------------------------------------------
# enumeration
# --------------------------------------------------------------------------

_WARPS = (1, 2, 4, 8, 16, 32)


def _points(rows: int, words: int, fixed: bool, heur, fix_nt=None,
            fix_warps=None):
    """(nt, warps) candidates: NT up to the first covering the rows, warps
    in powers of two up to the first covering the K words, each within
    the instantiation's launch bound, and the heuristic's point; a pinned
    axis keeps only its value (raising if no instantiation takes it)."""
    nts = (1, 2, 4) if fixed else (1,)
    if fix_nt is not None:
        max_warps(fixed, fix_nt)
        nts = (fix_nt,)
    else:
        cover = [nt for nt in nts if 8 * nt >= rows]
        nts = [nt for nt in nts if 8 * nt < rows] + cover[:1]
    pts = []
    for nt in nts:
        most = max_warps(fixed, nt)
        if fix_warps is not None:
            if 1 <= fix_warps <= most:
                pts.append((nt, fix_warps))
            continue
        ws = [w for w in _WARPS if w <= most]
        pts += [(nt, w) for w in [w for w in ws if w < words]
                + [w for w in ws if w >= words][:1]]
    if (heur not in pts and fix_nt in (None, heur[0])
            and fix_warps in (None, heur[1])):
        pts.append(heur)
    if not pts:
        raise ValueError(f"no instantiation takes {fix_warps} warps at "
                         f"NT {list(nts)}")
    return pts


#: the modeled gain under which the heuristic's tile is kept: the model's
#: error at the tiles it was fitted to (log-RMS 0.159, PERF.md §6) is
#: larger than a smaller predicted gain
KEEP_MARGIN = 0.10


def _ranked(cands, heur):
    """Cheapest first (ties: fewer warps, smaller blocks), except that the
    heuristic's tile leads unless the cheapest is modeled at least
    :data:`KEEP_MARGIN` faster."""
    def point(c):
        blk, w = dataclasses.astuple(c)[:2]
        return blk // 8, w
    out = sorted(cands, key=lambda c: (c.cost, point(c)[1], point(c)[0]))
    keep = [c for c in out if point(c) == heur]
    if keep and out[0].cost > keep[0].cost * (1 - KEEP_MARGIN):
        out.remove(keep[0])
        out.insert(0, keep[0])
    return out


def tile_candidates(m: int, k: int, n: int, spec, *,
                    out_bits: Optional[int] = None, codes: bool = False,
                    h100: H100Config = _H100):
    """Every admissible K3 (K4 with ``codes``) tile of the shape, modeled
    cost ascending (the first is :func:`choose_tile`'s pick)."""
    fixed = _fixed(spec)
    heur = heuristic_tile(m, k, n, spec)
    budget = cost_model.smem_budget_bytes(h100)
    cands = []
    for nt, w in _points(m, -(-k // 32), fixed, heur):
        smem = kernel_smem_bytes(nt)
        if smem > budget or 32 * w > launch_bound_threads(fixed, nt):
            continue
        cost = kernel_cost(m, k, n, a_bits=spec.a_bits, w_bits=spec.w_bits,
                           a_signed=spec.a_signed, w_signed=spec.w_signed,
                           nt=nt, warps=w, codes=codes, out_bits=out_bits,
                           h100=h100)
        cands.append(TileConfig(8 * nt, w, cost, smem))
    return _ranked(cands, heur)


def conv_tile_candidates(n: int, h: int, w: int, ci: int, co: int, *,
                         fh: int, fw: int, stride: int, padding: int, spec,
                         out_bits: Optional[int] = None,
                         fix_bp: Optional[int] = None,
                         fix_warps: Optional[int] = None,
                         h100: H100Config = _H100):
    """Every admissible K2 tile of the shape (pinned axes kept to their
    value), modeled cost ascending."""
    fixed = _fixed(spec)
    heur = heuristic_conv_tile(n, h, w, ci, co, fh=fh, fw=fw, stride=stride,
                               padding=padding, spec=spec)
    rows, words = _conv_rows_words(n, h, w, ci, fh, fw, stride, padding)
    budget = cost_model.smem_budget_bytes(h100)
    cands = []
    for nt, wp in _points(rows, words, fixed, heur,
                          None if fix_bp is None else _nt(fix_bp),
                          fix_warps):
        smem = conv_kernel_smem_bytes(nt)
        if smem > budget or 32 * wp > launch_bound_threads(fixed, nt):
            continue
        cost = conv_kernel_cost(n, h, w, ci, co, fh=fh, fw=fw,
                                stride=stride, padding=padding,
                                a_bits=spec.a_bits, w_bits=spec.w_bits,
                                a_signed=spec.a_signed,
                                w_signed=spec.w_signed, nt=nt, warps=wp,
                                out_bits=out_bits, h100=h100)
        cands.append(ConvTileConfig(8 * nt, wp, cost, smem))
    return _ranked(cands, heur)


def choose_tile(m: int, k: int, n: int, spec, *,
                out_bits: Optional[int] = None, codes: bool = False,
                h100: H100Config = _H100) -> TileConfig:
    """Pick the K3 tile (K4's with ``codes``) for one (m, k) x (k, n)
    product. ``out_bits``: the packed output's bits when the epilogue packs
    (changes the output's bytes); None for a float output and for the raw
    int32 accumulator (``raw_acc``), whose bytes are the same. Memoized
    per (shape, plans, out_bits, codes, card)."""
    key = (m, k, n, spec, out_bits, codes, _card(h100))

    def tune():
        return tile_candidates(m, k, n, spec, out_bits=out_bits,
                               codes=codes, h100=h100)[0]
    return _memoized(key, TileConfig, "tile", tune)


def _measured(cands, measure):
    """The measured winner of the analytic shortlist: strict ``<`` keeps
    the analytic best on ties, so it is never slower under ``measure``."""
    best, best_t = None, None
    for c in cands:
        t = float(measure(c))
        if best is None or t < best_t:
            best, best_t = c, t
    return best


def choose_tile_measured(m: int, k: int, n: int, spec, *, measure,
                         out_bits: Optional[int] = None, codes: bool = False,
                         top_k: int = 4,
                         h100: H100Config = _H100) -> TileConfig:
    """Measured re-rank: time the ``top_k`` analytically cheapest tiles
    with the caller's ``measure(cfg) -> seconds`` and keep the fastest
    (the analytic best on ties). Persisted and memoized as kind
    ``tile_measured``: a warm boot replays it without measuring."""
    key = ("measured", m, k, n, spec, out_bits, codes, top_k, _card(h100))

    def tune():
        cands = tile_candidates(m, k, n, spec, out_bits=out_bits,
                                codes=codes, h100=h100)[:max(1, top_k)]
        return _measured(cands, measure)
    return _memoized(key, TileConfig, "tile_measured", tune)


def choose_conv_tile(n: int, h: int, w: int, ci: int, co: int, *, fh: int,
                     fw: int, stride: int, padding: int, spec,
                     out_bits: Optional[int] = None,
                     fix_bp: Optional[int] = None,
                     fix_warps: Optional[int] = None,
                     h100: H100Config = _H100) -> ConvTileConfig:
    """Pick the K2 tile (output pixels per block, K-split warps) for one
    conv shape. ``fix_bp``/``fix_warps`` pin one axis (a caller override)
    while the other is still tuned and checked against the budget and the
    launch bound. Memoized per (shape, plans, out_bits, pins, card)."""
    key = ("conv", n, h, w, ci, co, fh, fw, stride, padding, spec, out_bits,
           fix_bp, fix_warps, _card(h100))

    def tune():
        return conv_tile_candidates(
            n, h, w, ci, co, fh=fh, fw=fw, stride=stride, padding=padding,
            spec=spec, out_bits=out_bits, fix_bp=fix_bp,
            fix_warps=fix_warps, h100=h100)[0]
    return _memoized(key, ConvTileConfig, "conv_tile", tune)


def choose_conv_tile_measured(n: int, h: int, w: int, ci: int, co: int, *,
                              fh: int, fw: int, stride: int, padding: int,
                              spec, measure,
                              out_bits: Optional[int] = None,
                              top_k: int = 4,
                              h100: H100Config = _H100
                              ) -> ConvTileConfig:
    """Measured re-rank for K2, :func:`choose_tile_measured`'s contract
    (kind ``conv_tile_measured``)."""
    key = ("conv_measured", n, h, w, ci, co, fh, fw, stride, padding, spec,
           out_bits, top_k, _card(h100))

    def tune():
        cands = conv_tile_candidates(
            n, h, w, ci, co, fh=fh, fw=fw, stride=stride, padding=padding,
            spec=spec, out_bits=out_bits, h100=h100)[:max(1, top_k)]
        return _measured(cands, measure)
    return _memoized(key, ConvTileConfig, "conv_tile_measured", tune)
