"""Model registry: many compiled :class:`~repro_torch.compiler.lower.Program`s
behind stable (model, precision) keys.

Counterpart of ``repro/serving/registry.py``. The paper's headline is
run-time programmability: the SAME fabric serves DNNs at several
quantization levels without reconfiguration. The registry is the software
analogue — one model graph registered once, materialized lazily at any
number of :class:`~repro_torch.models.layers.QuantPolicy` precisions, with:

* **lazy compile** — ``register_graph`` stores the recipe (graph + calib +
  policy); ``compile_graph`` runs on first :meth:`program` and the Program
  is cached;
* **packed-weight sharing** — bit-transposed weight planes depend only on
  the float weights and the weight quantizer ``(w_bits, w_signed)``, *not*
  on the activation precision, so W2A2 and W2A8 variants of one model hold
  the same ``w_packed`` tensors on the device. Sharing is content-addressed
  (a SHA-256 digest of the packed int32 words, their device, dtype and
  shape), so it also deduplicates across models that share layers;
* **LRU eviction** — at most ``max_programs`` compiled graph entries stay
  resident; evicted ones recompile transparently on next use (pinned
  Programs and opaque callables are never evicted);
* **artifact store** — with ``store=`` (an
  :class:`~repro_torch.compiler.artifact.ArtifactStore` or a directory
  path), :meth:`program` consults the store *before* ``compile_graph``
  (keyed by :func:`~repro_torch.compiler.artifact.recipe_digest`), freshly
  compiled Programs are saved and tagged ``model@precision``, eviction
  spills to a disk reference so re-admission is a load rather than a
  recompile, and :meth:`warm_boot` restores every variant with zero
  compiles. The store is also the tile tuner's persistent L2
  (:func:`repro_torch.kernels.tuning.set_persistent_store`), so a process
  booted warm from a populated store enumerates no tile either, the
  padding buckets' included. Loads land on the registry's device. Fleet processes with no
  compile recipe at all register through :meth:`register_artifact`.

The reference's ``backend``/``interpret`` are the port's ``plain`` (the
kernels' plain versions) and ``device`` (default: the card).

Opaque engines (e.g. the continuous LM engine, whose serving loop is not a
single Program call) register through :meth:`register_callable` and serve
through the same front end (:mod:`repro_torch.serving.service`).
"""

from __future__ import annotations

import collections
import dataclasses
import hashlib
import os
import threading
import weakref
from typing import Callable, Dict, List, Optional

import torch

from repro_torch import resolve_device
from repro_torch.obs.metrics import MetricsRegistry

__all__ = ["ModelKey", "ModelRegistry", "precision_label"]


@dataclasses.dataclass(frozen=True)
class ModelKey:
    """Stable handle for one servable variant: a model at one precision."""

    model: str
    precision: str  # e.g. "W2A2"; "native" for opaque engines

    def __str__(self) -> str:
        return f"{self.model}@{self.precision}"


def precision_label(policy) -> str:
    """Default precision tag of a QuantPolicy: ``W{w_bits}A{a_bits}``."""
    return f"W{policy.w_bits}A{policy.a_bits}"


def packed_digest(t: torch.Tensor) -> str:
    """Content address of a packed weight tensor on its device: SHA-256
    over the device, dtype, shape and bytes (one host copy, at
    registration)."""
    h = hashlib.sha256(f"{t.device}{t.dtype}{tuple(t.shape)}".encode())
    h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


@dataclasses.dataclass
class _Entry:
    # "graph" | "artifact" | "program" | "callable"
    kind: str
    graph: object = None            # graph entries: the compile recipe
    calib: object = None
    policy: object = None
    per_layer: Optional[Dict] = None
    device: Optional[torch.device] = None
    program: object = None          # program entries: pinned Program
    fn: Optional[Callable] = None   # callable entries: opaque batch engine
    stream: object = None           # optional CommandStream for scheduling
    max_batch: Optional[int] = None  # per-entry cap (callable engines)
    recipe: Optional[str] = None    # recipe_digest (graph entries w/ store)
    ref: Optional[str] = None       # artifact ref once saved/registered


class ModelRegistry:
    """Registry of servable model variants (see module docstring).

    ``plain`` makes the service run this registry's Programs through the
    kernels' plain versions; ``device`` is where graph entries compile and
    artifacts load (compiles overridable per registration). ``store``: an
    :class:`~repro_torch.compiler.artifact.ArtifactStore` or its directory.
    Thread-safe: the serving
    worker and user threads may call :meth:`program` concurrently.
    """

    def __init__(self, *, max_programs: Optional[int] = None,
                 plain: bool = False, device=None, store=None,
                 metrics: Optional[MetricsRegistry] = None):
        self.plain = plain
        self.device = resolve_device(device)
        self.max_programs = max_programs
        if isinstance(store, (str, os.PathLike)):
            from repro_torch.compiler.artifact import ArtifactStore
            store = ArtifactStore(os.fspath(store))
        self.store = store
        if store is not None:
            # L2 of the tile tuner: a restart with the same store
            # re-enumerates nothing (kernels/tuning keeps its L1 LRU)
            from repro_torch.kernels import tuning
            tuning.set_persistent_store(store)
        self._entries: Dict[ModelKey, _Entry] = {}  # guarded-by: _lock
        # compiled graph-entry Programs only, LRU order (pinned Programs
        # live in their _Entry and never evict)
        self._lru: "collections.OrderedDict[ModelKey, object]" = \
            collections.OrderedDict()                   # guarded-by: _lock
        # weak values: a plane shared only by evicted Programs must not be
        # kept alive by the dedup cache itself
        self._pack_cache: "weakref.WeakValueDictionary[str, torch.Tensor]" \
            = weakref.WeakValueDictionary()             # guarded-by: _lock
        self._lock = threading.RLock()
        # registry-backed counters (every write happens under self._lock)
        self.metrics_registry = (metrics if metrics is not None
                                 else MetricsRegistry())
        m = self.metrics_registry
        self._c_compiles = m.counter("registry_compiles_total",
                                     "compile_graph invocations")
        self._c_evictions = m.counter("registry_evictions_total",
                                      "LRU evictions")
        self._c_shared_arrays = m.counter(
            "registry_shared_arrays_total",
            "packed planes deduped across variants")
        self._c_shared_bytes = m.counter(
            "registry_shared_bytes_total", "bytes saved by plane dedup")
        self._c_art_hits = m.counter(
            "registry_artifact_hits_total",
            "compiles avoided by a store load")
        self._c_art_saves = m.counter(
            "registry_artifact_saves_total", "programs written to the store")
        self._c_art_spills = m.counter(
            "registry_artifact_spills_total",
            "evictions that left a disk reference")

    @property
    def compiles(self) -> int:
        return int(self._c_compiles.value())

    @property
    def evictions(self) -> int:
        return int(self._c_evictions.value())

    @property
    def shared_arrays(self) -> int:
        return int(self._c_shared_arrays.value())

    @property
    def shared_bytes(self) -> int:
        return int(self._c_shared_bytes.value())

    @property
    def artifact_hits(self) -> int:
        return int(self._c_art_hits.value())

    @property
    def artifact_saves(self) -> int:
        return int(self._c_art_saves.value())

    @property
    def artifact_spills(self) -> int:
        return int(self._c_art_spills.value())

    # -------------------------------------------------------- registration
    def register_graph(self, model: str, graph, calib, policy, *,
                       precision: Optional[str] = None,
                       per_layer: Optional[Dict] = None,
                       device=None) -> ModelKey:
        """Register a compile recipe; compilation is deferred to first use.

        The same ``graph`` object may be registered under several policies
        — variants whose layers quantize weights identically share the
        packed planes on the device.
        """
        key = ModelKey(model, precision or precision_label(policy))
        e = _Entry(
            "graph", graph=graph, calib=calib, policy=policy,
            per_layer=per_layer,
            device=self.device if device is None else resolve_device(device))
        if self.store is not None:
            from repro_torch.compiler.artifact import recipe_digest
            e.recipe = recipe_digest(graph, calib, policy,
                                     per_layer=per_layer,
                                     route=f"torch:{e.device.type}")
        with self._lock:
            self._check_new(key)
            self._entries[key] = e
        return key

    def register_artifact(self, model: str, *, precision: str,
                          ref: Optional[str] = None) -> ModelKey:
        """Register a variant backed *only* by a stored artifact — the
        fleet path: no graph, no calibration data, no compiler run. ``ref``
        defaults to the store's ``model@precision`` name tag."""
        from repro_torch.compiler.artifact import ArtifactError
        if self.store is None:
            raise ValueError("register_artifact requires a registry store")
        key = ModelKey(model, precision)
        if ref is None:
            ref = self.store.resolve(str(key))
            if ref is None:
                raise ArtifactError(
                    f"no artifact tagged {key} in store {self.store.root} "
                    f"(tags: {sorted(self.store.tags())})")
        if not self.store.has_program(ref):
            raise ArtifactError(f"unknown program ref {ref[:12]}… for {key}")
        with self._lock:
            self._check_new(key)
            self._entries[key] = _Entry("artifact", ref=ref)
        return key

    def register_program(self, model: str, program, *,
                         precision: str) -> ModelKey:
        """Register an already-compiled Program (pinned: never evicted)."""
        key = ModelKey(model, precision)
        with self._lock:
            self._check_new(key)
            self._share_packed(program)
            self._entries[key] = _Entry("program", program=program)
        return key

    def register_callable(self, model: str, fn: Callable, *,
                          precision: str = "native", stream=None,
                          max_batch: Optional[int] = None) -> ModelKey:
        """Register an opaque batch engine: ``fn(requests) -> results``
        (one result per request, in order). ``stream``: an optional
        :class:`~repro_torch.core.codegen.CommandStream` so the slot
        scheduler can cost it; without one the engine serves
        unscheduled."""
        key = ModelKey(model, precision)
        with self._lock:
            self._check_new(key)
            self._entries[key] = _Entry("callable", fn=fn, stream=stream,
                                        max_batch=max_batch)
        return key

    def _check_new(self, key: ModelKey) -> None:
        if key in self._entries:
            raise ValueError(f"{key} is already registered")

    # --------------------------------------------------------------- lookup
    def entry(self, key: ModelKey) -> _Entry:
        try:
            return self._entries[key]
        except KeyError:
            raise KeyError(f"unknown model variant {key} — registered: "
                           f"{[str(k) for k in self._entries]}") from None

    def program(self, key: ModelKey):
        """The compiled Program for ``key`` (lazy materialize + LRU touch).

        Materialization order: resident LRU hit → artifact-store load (by
        prior ref, then by recipe digest) → ``compile_graph``. A fresh
        compile is saved back to the store (when one is attached) and
        tagged ``model@precision``, so every later eviction re-admits via
        a disk load instead of a recompile."""
        with self._lock:
            e = self.entry(key)
            if e.kind == "program":
                return e.program
            if e.kind not in ("graph", "artifact"):
                raise TypeError(f"{key} is an opaque engine, not a Program")
            prog = self._lru.get(key)
            if prog is not None:
                self._lru.move_to_end(key)
                return prog
            prog = self._materialize(key, e)
            self._share_packed(prog)
            self._lru[key] = prog
            while (self.max_programs is not None
                   and len(self._lru) > self.max_programs):
                old_key, _ = self._lru.popitem(last=False)
                self._c_evictions.inc()
                oe = self._entries.get(old_key)
                if oe is not None and oe.ref is not None:
                    self._c_art_spills.inc()
            return prog

    def _materialize(self, key: ModelKey, e: _Entry):  # requires: _lock
        """Load from the store if possible, else compile (and save). A
        graph entry whose stored ref no longer loads falls through to a
        compile of its recipe (counted as a store miss), as the
        reference's does; an artifact entry has no recipe and raises."""
        from repro_torch.compiler.artifact import (ArtifactError,
                                                   load_program,
                                                   save_program)
        if self.store is not None:
            for ref in (e.ref,
                        self.store.resolve(f"recipe:{e.recipe}")
                        if e.recipe is not None else None):
                if ref is None:
                    continue
                try:
                    prog = load_program(
                        ref, self.store, device=(e.device if e.device
                                                 is not None else self.device))
                except ArtifactError:
                    if e.kind == "artifact":
                        raise   # no recipe to fall back on
                    continue    # stale/corrupt ref: compile the recipe
                e.ref = ref
                self._c_art_hits.inc()
                self.store._note_hit()
                # re-assert the name tag: a hit found only through the
                # recipe index must still be a GC root afterwards
                self.store.tag(str(key), ref)
                return prog
            self.store._note_miss()
        if e.kind == "artifact":
            raise ArtifactError(f"{key} is artifact-backed but has no "
                                "loadable artifact (store missing?)")
        from repro_torch.compiler.lower import compile_graph
        prog = compile_graph(e.graph, e.calib, policy=e.policy,
                             per_layer=e.per_layer, device=e.device)
        self._c_compiles.inc()
        if self.store is not None:
            e.ref = save_program(prog, self.store, name=str(key))
            if e.recipe is not None:
                self.store.tag(f"recipe:{e.recipe}", e.ref)
            self._c_art_saves.inc()
        return prog

    def warm_boot(self) -> Dict:
        """Materialize every graph/artifact variant up front, preferring
        the artifact store. With a fully populated store this performs
        **zero** ``compile_graph``. Returns ``{"restored": [...],
        "compiled": [...]}`` by variant name."""
        restored: List[str] = []
        compiled: List[str] = []
        for key in self.keys():
            if self.entry(key).kind not in ("graph", "artifact"):
                continue
            before = self.compiles
            self.program(key)
            (compiled if self.compiles > before
             else restored).append(str(key))
        return {"restored": restored, "compiled": compiled}

    def resident_program(self, key: ModelKey):
        """The cached Program if (and only if) resident — never compiles.

        Serving holds per-variant runner state (captured graphs included)
        keyed on Program identity; this is how it notices an eviction and
        releases its own reference instead of pinning the evicted Program
        forever.
        """
        with self._lock:
            e = self.entry(key)
            return e.program if e.kind == "program" else self._lru.get(key)

    def keys(self) -> List[ModelKey]:
        return list(self._entries)

    def variants(self, model: str) -> List[ModelKey]:
        """All registered precisions of one model."""
        return [k for k in self._entries if k.model == model]

    # ------------------------------------------------------- weight sharing
    def _share_packed(self, program) -> None:  # requires: _lock
        """Content-addressed dedup of ahead-of-time packed weight planes.

        Packed planes are a pure function of (float weights, w_bits,
        w_signed) — activation precision never enters — so the digest of
        the packed words is a sound sharing key across precisions/models.
        """
        params = getattr(program, "params", None)
        if not params:
            return
        for p in params.values():
            arr = p.get("w_packed")
            if arr is None:
                continue
            digest = packed_digest(arr)
            hit = self._pack_cache.get(digest)
            if hit is not None and hit is not arr:
                p["w_packed"] = hit   # drop the duplicate device buffer
                self._c_shared_arrays.inc()
                self._c_shared_bytes.inc(arr.numel() * arr.element_size())
            elif hit is None:
                self._pack_cache[digest] = arr

    # -------------------------------------------------------------- metrics
    def stats(self) -> Dict:
        with self._lock:
            return {
                "entries": len(self._entries),
                "resident_programs": len(self._lru) + sum(
                    1 for e in self._entries.values()
                    if e.kind == "program"),
                "compiles": self.compiles,
                "evictions": self.evictions,
                "shared_arrays": self.shared_arrays,
                "shared_bytes": self.shared_bytes,
                "pack_cache_entries": len(self._pack_cache),
                "artifact_hits": self.artifact_hits,
                "artifact_saves": self.artifact_saves,
                "artifact_spills": self.artifact_spills,
                "artifact_store": (None if self.store is None
                                   else self.store.stats()),
            }
