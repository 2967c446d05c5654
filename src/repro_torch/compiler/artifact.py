"""AOT Program artifacts: compile once, warm-boot the registry from disk.

The port's copy of ``repro/compiler/artifact.py``, in the same on-disk
format (``FORMAT``/``VERSION``, manifest schema, ``.npy`` blobs written
with ``allow_pickle=False``, :func:`array_digest`), so the two packages
share a store: a store written by the JAX package on a build host boots
the card's server, and a store the port writes holds the same plane
blobs under the same digests.

BARVINN's deployment story is "code generator → executable command
stream": the *artifact* is the shippable object, not the compiler run.

* :func:`save_program` / :func:`load_program` — serialize everything
  ``compile_graph`` produced: the packed weight digit planes, folded
  scalers/biases, the :class:`Step` list (with ``LoweredConv``/
  ``LoweredGemm`` codegen metadata), the quant policy, and the pipelined
  per-MVU command stream (stored job for job and re-derived at load by the
  port's codegen, so a stale artifact compiled by a different codegen is
  rejected instead of silently mis-costed). The port carries packed words
  as int32 bit-views; they are written as uint32, the reference's dtype,
  and viewed back as int32 on load, so a plane has one digest in both
  packages;
* :class:`ArtifactStore` — a directory-backed content-addressed store.
  Array blobs are keyed by :func:`array_digest`, so a packed plane shared
  by several precision variants is stored **once** on disk; at load every
  blob becomes one tensor on the Program's device, so variants loaded
  together share it there too. Manifests are content-addressed by their
  canonical JSON;
* integrity — a format/version header on every manifest, the manifest hash
  checked against its ref, and every blob re-digested on read: corrupted
  files, truncated planes, hash mismatches and format-version bumps all
  raise :class:`ArtifactError`; a manifest edited *and* re-digested is
  caught by :func:`~repro_torch.analysis.verify_ir.verify_program`, which
  every load runs;
* :func:`recipe_digest` — a deterministic key over (graph, calib, policy,
  per-layer overrides, route) that lets
  :class:`~repro_torch.serving.registry.ModelRegistry` consult the store
  *before* calling ``compile_graph``, and :meth:`ArtifactStore.tag` name
  refs (``model@precision``) so a fleet process can register artifacts by
  name with no compile recipe at all.

Tiles: the port's tuned tiles (:mod:`repro_torch.kernels.tuning`'s
``TileConfig``/``ConvTileConfig`` in step attrs ``tile`` and
``meta["tiles"]``) round-trip under markers of their own
(``__h100tile__``/``__h100convtile__``). The reference's TPU tiles (a
``tile`` dict of VMEM blocks, ``__tile__``/``__convtile__`` in
``meta["tiles"]``) are decoded and dropped at load: its steps launch the
kernels' own heuristic. The store's ``tuning/`` holds the tuner's
decisions (kinds ``tile``, ``conv_tile``, ``tile_measured``,
``conv_tile_measured``; :func:`repro_torch.kernels.tuning.set_persistent_store`)
and persisted calibrations (:mod:`repro_torch.obs.calibrate`).
"""

from __future__ import annotations

import dataclasses
import hashlib
import io
import json
import os
import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.obs.metrics import MetricsRegistry

__all__ = ["ArtifactError", "ArtifactStore", "array_digest",
           "save_program", "load_program", "recipe_digest",
           "FORMAT", "VERSION"]

FORMAT = "repro-program-artifact"
VERSION = 1

#: params that hold packed words: int32 bit-views in the port, uint32 on
#: disk (the reference's dtype)
_PLANE_KEYS = ("w_packed",)


class ArtifactError(RuntimeError):
    """A stored artifact is missing, corrupt, stale, or incompatible."""


def _as_numpy(arr) -> np.ndarray:
    if isinstance(arr, torch.Tensor):
        return arr.detach().cpu().numpy()
    return np.asarray(arr)


def array_digest(arr) -> str:
    """Content hash of one array: bytes + shape + dtype (the reference's
    digest, so one blob has one name in both packages)."""
    a = _as_numpy(arr)
    h = hashlib.sha256()
    h.update(str((a.shape, str(a.dtype))).encode())
    h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


# --------------------------------------------------------------------------
# JSON codec for the non-array Program payload
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TileConfig:
    """The reference's tuned GEMM tile (``repro/kernels/tuning.py``), as a
    manifest names it; decoded so a reference store loads, then dropped."""

    block_m: int
    block_n: int
    block_k: int
    cache_weights: bool
    cache_acts: bool
    cost: float = 0.0
    vmem_bytes: int = 0


@dataclasses.dataclass(frozen=True)
class ConvTileConfig:
    """The reference's tuned conv tile, as a manifest names it."""

    block_co: int
    block_nb: int
    cache_weights: bool
    cache_acts: bool
    cost: float = 0.0
    vmem_bytes: int = 0


def _port_tile(v) -> bool:
    from repro_torch.kernels import tuning
    return isinstance(v, (tuning.TileConfig, tuning.ConvTileConfig))


def _enc(v):
    from repro_torch.compiler.lower import LoweredConv, LoweredGemm
    from repro_torch.core.bitserial import SerialSpec
    from repro_torch.kernels import tuning
    if v is None or isinstance(v, (bool, int, float, str)):
        return v
    if isinstance(v, (np.integer,)):
        return int(v)
    if isinstance(v, (np.floating,)):
        return float(v)
    if isinstance(v, tuple):
        return {"__t__": [_enc(x) for x in v]}
    if isinstance(v, list):
        return [_enc(x) for x in v]
    if isinstance(v, dict):
        return {str(k): _enc(x) for k, x in v.items()}
    if isinstance(v, SerialSpec):
        return {"__serialspec__": dataclasses.asdict(v)}
    if isinstance(v, tuning.TileConfig):
        return {"__h100tile__": dataclasses.asdict(v)}
    if isinstance(v, tuning.ConvTileConfig):
        return {"__h100convtile__": dataclasses.asdict(v)}
    if isinstance(v, TileConfig):
        return {"__tile__": dataclasses.asdict(v)}
    if isinstance(v, ConvTileConfig):
        return {"__convtile__": dataclasses.asdict(v)}
    if isinstance(v, LoweredConv):
        return {"__lconv__": dataclasses.asdict(v)}
    if isinstance(v, LoweredGemm):
        return {"__lgemm__": dataclasses.asdict(v)}
    raise ArtifactError(f"cannot serialize value of type {type(v).__name__}")


def _dec(v):
    from repro_torch.compiler.lower import LoweredConv, LoweredGemm
    from repro_torch.core.bitserial import SerialSpec
    from repro_torch.kernels import tuning
    if isinstance(v, list):
        return [_dec(x) for x in v]
    if isinstance(v, dict):
        if "__t__" in v:
            return tuple(_dec(x) for x in v["__t__"])
        if "__serialspec__" in v:
            return SerialSpec(**v["__serialspec__"])
        if "__h100tile__" in v:
            return tuning.TileConfig(**v["__h100tile__"])
        if "__h100convtile__" in v:
            return tuning.ConvTileConfig(**v["__h100convtile__"])
        if "__tile__" in v:
            return TileConfig(**v["__tile__"])
        if "__convtile__" in v:
            return ConvTileConfig(**v["__convtile__"])
        if "__lconv__" in v:
            return LoweredConv(**v["__lconv__"])
        if "__lgemm__" in v:
            return LoweredGemm(**v["__lgemm__"])
        return {k: _dec(x) for k, x in v.items()}
    return v


def _encode_job(j) -> Dict:
    """One :class:`~repro_torch.core.mvu.MVUJob` as a JSON-plain record
    (the stored-vs-regenerated command-stream drift check; never
    decoded)."""
    def agu(a):
        return None if a is None else {
            "base": int(a.base),
            "loops": [[int(l.length), int(l.jump)] for l in a.loops]}
    return {
        "op": j.op.value, "mvu": j.mvu, "a_bits": j.a_bits,
        "w_bits": j.w_bits, "a_signed": j.a_signed, "w_signed": j.w_signed,
        "out_bits": j.out_bits, "m_tiles": j.m_tiles, "k_tiles": j.k_tiles,
        "n_outputs": j.n_outputs, "agu_act": agu(j.agu_act),
        "agu_wgt": agu(j.agu_wgt), "use_scaler": j.use_scaler,
        "use_pool": j.use_pool, "use_relu": j.use_relu,
        "dest_mvu": j.dest_mvu, "tag": j.tag,
        "depends_on": list(j.depends_on),
    }


def _encode_stream(program) -> List[Dict]:
    return [_encode_job(j) for j in program.to_command_stream(
        mode="pipelined").jobs]


# --------------------------------------------------------------------------
# the store
# --------------------------------------------------------------------------

class ArtifactStore:
    """Directory-backed content-addressed artifact store.

    Layout under ``root``::

        blobs/<sha256>.npy       array blobs (packed planes, scalers, ...)
        programs/<sha256>.json   program manifests (format/version header)
        refs/<name>              name/recipe tag -> program ref
        tuning/<sha1>.json       persisted records (tuned tiles,
                                 calibrations)

    Writes are append-only: blobs are never deleted by normal operation,
    so evicting a resident Program (or dropping a whole registry) can
    never orphan a plane a sibling variant's artifact still references.
    Space is reclaimed explicitly via :meth:`gc`, which drops manifests no
    ref tag points at and blobs no surviving manifest references — with a
    dry-run mode that only reports. All writes are atomic (tmp + rename);
    counters are in-process accounting for this session, disk totals are
    computed from the tree.
    """

    def __init__(self, root: str, *,
                 metrics: Optional[MetricsRegistry] = None):
        self.root = str(root)
        for d in ("blobs", "programs", "refs", "tuning"):
            os.makedirs(os.path.join(self.root, d), exist_ok=True)
        self._lock = threading.Lock()
        # registry-backed session counters (writes under self._lock)
        self.metrics_registry = (metrics if metrics is not None
                                 else MetricsRegistry())
        m = self.metrics_registry
        self._c_hits = m.counter("artifact_hits_total",
                                 "program lookups served from disk")
        self._c_misses = m.counter("artifact_misses_total",
                                   "program lookups that found nothing")
        self._c_loads = m.counter("artifact_loads_total",
                                  "programs materialized from disk")
        self._c_saves = m.counter("artifact_saves_total",
                                  "programs written")
        self._c_blob_writes = m.counter("artifact_blob_writes_total",
                                        "blobs written")
        self._c_blob_dedups = m.counter(
            "artifact_blob_dedups_total",
            "put_array calls that found the blob")
        self._c_logical_bytes = m.counter(
            "artifact_logical_bytes_total",
            "bytes referenced by saved programs")
        self._h_load = m.histogram(
            "artifact_load_seconds", "program load wall time")
        self._load_ms: List[float] = []   # guarded-by: _lock

    @property
    def hits(self) -> int:
        return int(self._c_hits.value())

    @property
    def misses(self) -> int:
        return int(self._c_misses.value())

    @property
    def loads(self) -> int:
        return int(self._c_loads.value())

    @property
    def saves(self) -> int:
        return int(self._c_saves.value())

    @property
    def blob_writes(self) -> int:
        return int(self._c_blob_writes.value())

    @property
    def blob_dedups(self) -> int:
        return int(self._c_blob_dedups.value())

    @property
    def logical_bytes(self) -> int:
        return int(self._c_logical_bytes.value())

    # ------------------------------------------------------------- paths
    def _blob_path(self, digest: str) -> str:
        return os.path.join(self.root, "blobs", f"{digest}.npy")

    def _program_path(self, ref: str) -> str:
        return os.path.join(self.root, "programs", f"{ref}.json")

    def _ref_path(self, name: str) -> str:
        safe = name.replace(os.sep, "_").replace("/", "_")
        return os.path.join(self.root, "refs", safe)

    @staticmethod
    def _atomic_write(path: str, data: bytes) -> None:
        tmp = f"{path}.tmp.{os.getpid()}.{threading.get_ident()}"
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, path)

    # ------------------------------------------------------------- blobs
    def put_array(self, arr) -> str:
        """Store one numpy array content-addressed; returns its digest. A
        blob already present (a packed plane shared by a sibling precision
        variant) is not rewritten — that is the on-disk dedup."""
        a = np.asarray(arr)
        digest = array_digest(a)
        path = self._blob_path(digest)
        with self._lock:
            self._c_logical_bytes.inc(a.nbytes)
            if os.path.exists(path):
                self._c_blob_dedups.inc()
                return digest
            self._c_blob_writes.inc()
        buf = io.BytesIO()
        np.save(buf, a, allow_pickle=False)
        self._atomic_write(path, buf.getvalue())
        return digest

    def get_array(self, digest: str) -> np.ndarray:
        """Load + integrity-check one blob (digest recomputed on read)."""
        path = self._blob_path(digest)
        if not os.path.exists(path):
            raise ArtifactError(f"missing blob {digest[:12]}… — the store "
                                f"at {self.root} has no {path}")
        try:
            a = np.load(path, allow_pickle=False)
        except (ValueError, OSError, EOFError) as e:
            raise ArtifactError(
                f"blob {digest[:12]}… is unreadable (truncated or not a "
                f".npy file): {e}") from e
        actual = array_digest(a)
        if actual != digest:
            raise ArtifactError(
                f"blob {digest[:12]}… failed its integrity check "
                f"(content hashes to {actual[:12]}… — corrupted plane?)")
        return a

    # ---------------------------------------------------------- programs
    def put_program(self, manifest: Dict) -> str:
        """Write one manifest; returns its content-addressed ref."""
        payload = json.dumps(manifest, sort_keys=True).encode()
        ref = hashlib.sha256(payload).hexdigest()
        path = self._program_path(ref)
        if not os.path.exists(path):
            self._atomic_write(path, payload)
        with self._lock:
            self._c_saves.inc()
        return ref

    def get_program(self, ref: str) -> Dict:
        """Read + verify one manifest (hash vs ref, format, version)."""
        path = self._program_path(ref)
        if not os.path.exists(path):
            raise ArtifactError(f"unknown program ref {ref[:12]}… in store "
                                f"{self.root}")
        with open(path, "rb") as f:
            payload = f.read()
        actual = hashlib.sha256(payload).hexdigest()
        if actual != ref:
            raise ArtifactError(
                f"program manifest {ref[:12]}… failed its integrity check "
                f"(content hashes to {actual[:12]}… — tampered or corrupt)")
        try:
            manifest = json.loads(payload)
        except ValueError as e:
            raise ArtifactError(f"program manifest {ref[:12]}… is not "
                                f"valid JSON: {e}") from e
        if manifest.get("format") != FORMAT:
            raise ArtifactError(
                f"{ref[:12]}… is not a {FORMAT} manifest "
                f"(format={manifest.get('format')!r})")
        if manifest.get("version") != VERSION:
            raise ArtifactError(
                f"artifact {ref[:12]}… has format version "
                f"{manifest.get('version')!r}, this build reads version "
                f"{VERSION} — recompile the model to refresh the store")
        return manifest

    def has_program(self, ref: str) -> bool:
        return os.path.exists(self._program_path(ref))

    # -------------------------------------------------------------- refs
    def tag(self, name: str, ref: str) -> None:
        """Point a stable name (``model@precision`` or ``recipe:<digest>``)
        at a program ref."""
        self._atomic_write(self._ref_path(name), ref.encode())

    def resolve(self, name: str) -> Optional[str]:
        path = self._ref_path(name)
        if not os.path.exists(path):
            return None
        with open(path) as f:
            return f.read().strip()

    def tags(self) -> Dict[str, str]:
        out = {}
        d = os.path.join(self.root, "refs")
        for name in sorted(os.listdir(d)):
            with open(os.path.join(d, name)) as f:
                out[name] = f.read().strip()
        return out

    def untag(self, name: str) -> bool:
        """Drop one ref tag (the artifact it pointed at becomes
        collectable by :meth:`gc` unless another *name* tag still reaches
        it — ``recipe:`` index entries don't root anything).
        Returns whether the tag existed."""
        path = self._ref_path(name)
        if not os.path.exists(path):
            return False
        os.remove(path)
        return True

    # ---------------------------------------------------------------- gc
    def gc(self, *, dry_run: bool = False) -> Dict:
        """Reclaim unreachable artifacts: manifests no *name* tag points
        at, then blobs no surviving manifest references.

        GC roots are the stable name tags (``model@precision``).
        ``recipe:<digest>`` tags are a derived lookup index, not
        ownership — every save re-tags its recipe, so treating them as
        roots would make every artifact immortal. Recipe (and otherwise
        dangling) tags whose target manifest dies are swept in the same
        pass; the registry tolerates a vanished recipe target anyway by
        falling back to a fresh compile.

        Reachability is the walk ``refs/* -> programs/<ref>.json ->
        params[*][*]["blob"]``, so a packed plane shared by several
        precision variants survives as long as any of them is still
        tagged. ``dry_run=True`` reports the would-be deletions without
        touching the tree. Unreadable manifest files are conservatively
        kept (they may be a concurrent writer's fresh rename target).
        """
        all_tags = self.tags()
        live_refs = {r for n, r in all_tags.items()
                     if not n.startswith("recipe:")}
        pdir = os.path.join(self.root, "programs")
        bdir = os.path.join(self.root, "blobs")
        dead_programs: List[str] = []
        live_blobs: set = set()
        for fname in sorted(os.listdir(pdir)):
            ref = fname[:-len(".json")] if fname.endswith(".json") else fname
            if ref not in live_refs:
                dead_programs.append(fname)
                continue
            try:
                with open(os.path.join(pdir, fname)) as f:
                    m = json.load(f)
            except (ValueError, OSError):
                continue   # unreadable but tagged: keep, reference nothing
            for p in m.get("params", {}).values():
                for rec in p.values():
                    if rec.get("blob"):
                        live_blobs.add(rec["blob"])
        dead_blobs = [n for n in sorted(os.listdir(bdir))
                      if n[:-len(".npy")] not in live_blobs]
        # index hygiene: recipe/dangling tags whose manifest is going away
        # (or is already gone) leave with it
        dead_refs = {f[:-len(".json")] if f.endswith(".json") else f
                     for f in dead_programs}
        dead_tags = [n for n, r in all_tags.items()
                     if n.startswith("recipe:")
                     and (r in dead_refs or not os.path.exists(
                         os.path.join(pdir, f"{r}.json")))]
        freed = sum(os.path.getsize(os.path.join(bdir, n))
                    for n in dead_blobs)
        freed += sum(os.path.getsize(os.path.join(pdir, n))
                     for n in dead_programs)
        if not dry_run:
            for n in dead_programs:
                os.remove(os.path.join(pdir, n))
            for n in dead_blobs:
                os.remove(os.path.join(bdir, n))
            for n in dead_tags:
                self.untag(n)
        return {
            "dry_run": dry_run,
            "live_programs": len(live_refs),
            "removed_programs": len(dead_programs),
            "live_blobs": len(live_blobs),
            "removed_blobs": len(dead_blobs),
            "removed_tags": len(dead_tags),
            "bytes_freed": freed,
        }

    # ------------------------------------------------------------ tuning
    def _tuning_path(self, key_repr: str) -> str:
        h = hashlib.sha1(key_repr.encode()).hexdigest()
        return os.path.join(self.root, "tuning", f"{h}.json")

    def tuning_put(self, key_repr: str, kind: str, payload: Dict) -> None:
        """Persist one keyed record (a tuned tile, a calibration)."""
        self._atomic_write(
            self._tuning_path(key_repr),
            json.dumps({"key": key_repr, "kind": kind,
                        "config": payload}, sort_keys=True).encode())

    def tuning_get(self, key_repr: str) -> Optional[Dict]:
        path = self._tuning_path(key_repr)
        if not os.path.exists(path):
            return None
        try:
            with open(path) as f:
                rec = json.load(f)
        except (ValueError, OSError):
            return None          # a corrupt record reads as absent
        if rec.get("key") != key_repr:   # sha1 collision / stale file
            return None
        return rec

    # ------------------------------------------------------- accounting
    def _note_hit(self) -> None:
        with self._lock:
            self._c_hits.inc()

    def _note_miss(self) -> None:
        with self._lock:
            self._c_misses.inc()

    def _note_load(self, ms: float) -> None:
        with self._lock:
            self._c_loads.inc()
            self._load_ms.append(ms)
            self._h_load.observe(ms / 1e3)
            if len(self._load_ms) > 4096:
                del self._load_ms[:-4096]

    def bytes_on_disk(self) -> int:
        total = 0
        for d in ("blobs", "programs"):
            p = os.path.join(self.root, d)
            for name in os.listdir(p):
                total += os.path.getsize(os.path.join(p, name))
        return total

    def _referenced_blob_bytes(self) -> int:
        """Blob bytes counted once per *reference* across all manifests —
        over physical blob bytes this is the on-disk dedup ratio (derived
        from the tree, so it survives process restarts)."""
        total = 0
        pdir = os.path.join(self.root, "programs")
        for name in os.listdir(pdir):
            try:
                with open(os.path.join(pdir, name)) as f:
                    m = json.load(f)
            except (ValueError, OSError):
                continue
            for p in m.get("params", {}).values():
                for rec in p.values():
                    path = self._blob_path(rec.get("blob", ""))
                    if os.path.exists(path):
                        total += os.path.getsize(path)
        return total

    def stats(self) -> Dict:
        with self._lock:
            ms = sorted(self._load_ms)
            p50 = ms[len(ms) // 2] if ms else 0.0
            physical = self.bytes_on_disk()
            blob_dir = os.path.join(self.root, "blobs")
            return {
                "hits": self.hits,
                "misses": self.misses,
                "loads": self.loads,
                "saves": self.saves,
                "load_p50_ms": round(p50, 3),
                "bytes_on_disk": physical,
                "blobs": len(os.listdir(blob_dir)),
                "programs": len(os.listdir(
                    os.path.join(self.root, "programs"))),
                "blob_writes": self.blob_writes,
                "blob_dedups": self.blob_dedups,
                # bytes-as-referenced over bytes-on-disk: >1 means planes
                # are shared across variants on disk
                "dedup_ratio": round(
                    self._referenced_blob_bytes() / max(1, sum(
                        os.path.getsize(os.path.join(blob_dir, n))
                        for n in os.listdir(blob_dir))), 3),
            }


# --------------------------------------------------------------------------
# save / load
# --------------------------------------------------------------------------

def _blob_array(key: str, t) -> np.ndarray:
    """A Program parameter as it is stored: packed words as uint32."""
    a = _as_numpy(t)
    if key in _PLANE_KEYS and a.dtype == np.int32:
        a = a.view(np.uint32)
    return a


def save_program(program, store: ArtifactStore, *,
                 name: Optional[str] = None) -> str:
    """Serialize a compiled Program into ``store``; returns its ref.

    Every tensor in ``program.params`` becomes a content-addressed blob
    (packed planes as uint32) — planes shared across precision variants
    hash to the same digest and are stored once. ``name`` additionally
    tags the ref (``store.tag(name, ref)``) so fleets can load by
    ``model@precision`` with no compile recipe.
    """
    params_rec: Dict[str, Dict] = {}
    for step_name, p in program.params.items():
        rec = {}
        for k, t in p.items():
            a = _blob_array(k, t)
            rec[k] = {"blob": store.put_array(a),
                      "dtype": str(a.dtype),
                      "shape": list(a.shape)}
        params_rec[step_name] = rec
    manifest = {
        "format": FORMAT,
        "version": VERSION,
        "graph_name": program.graph_name,
        "input_name": program.input_name,
        "output_name": program.output_name,
        # the reference's (backend, interpret) slot: the port's route
        "backend": f"torch:{program.device.type}",
        "interpret": False,
        "steps": [{"name": s.name, "kind": s.kind,
                   "inputs": list(s.inputs), "output": s.output,
                   "attrs": _enc(dict(s.attrs))}
                  for s in program.steps],
        "params": params_rec,
        "cost_nodes": _enc(list(program.cost_nodes)),
        "per_layer_bits": _enc(dict(program.per_layer_bits)),
        "meta": _enc(dict(program.meta)),
        # the paper's executable artifact, job for job: re-derived at load
        # and compared, so artifacts from a drifted codegen are rejected
        "stream_pipelined": _encode_stream(program),
    }
    ref = store.put_program(manifest)
    if name:
        store.tag(name, ref)
    return ref


def load_program(ref_or_name: str, store: ArtifactStore, *, device=None):
    """Materialize a Program on ``device`` (default: the card) from the
    store with **zero recompiles** — no calibration, no weight packing, no
    codegen beyond the drift check.

    Accepts a program ref or a tagged name. Each blob is placed on the
    device once, so params that share a blob share one tensor. Raises
    :class:`ArtifactError` on any integrity failure (see module
    docstring)."""
    from repro_torch.compiler.lower import Program, Step, to_tensor

    device = resolve_device(device)
    t0 = time.perf_counter()
    ref = ref_or_name
    if not store.has_program(ref):
        resolved = store.resolve(ref_or_name)
        if resolved is None:
            raise ArtifactError(
                f"{ref_or_name!r} is neither a program ref nor a tagged "
                f"name in store {store.root} (tags: "
                f"{sorted(store.tags())})")
        ref = resolved
    manifest = store.get_program(ref)

    blob_cache: Dict[str, torch.Tensor] = {}

    def fetch(rec: Dict) -> torch.Tensor:
        t = blob_cache.get(rec["blob"])
        if t is None:
            a = store.get_array(rec["blob"])
            if (list(a.shape) != rec["shape"]
                    or str(a.dtype) != rec["dtype"]):
                raise ArtifactError(
                    f"blob {rec['blob'][:12]}… decodes to "
                    f"{a.dtype}{a.shape}, manifest expects "
                    f"{rec['dtype']}{tuple(rec['shape'])}")
            t = blob_cache[rec["blob"]] = to_tensor(a, device)
        return t

    params = {name: {k: fetch(rec) for k, rec in p.items()}
              for name, p in manifest["params"].items()}
    steps = []
    for s in manifest["steps"]:
        attrs = _dec(s["attrs"])
        if not _port_tile(attrs.get("tile")):
            attrs.pop("tile", None)      # the reference's VMEM blocks
        steps.append(Step(name=s["name"], kind=s["kind"],
                          inputs=tuple(s["inputs"]), output=s["output"],
                          attrs=attrs))
    meta = _dec(manifest["meta"])
    tiles = {k: t for k, t in (meta.pop("tiles", None) or {}).items()
             if _port_tile(t)}
    if tiles:
        meta["tiles"] = tiles
    program = Program(
        graph_name=manifest["graph_name"], steps=tuple(steps),
        params=params, input_name=manifest["input_name"],
        output_name=manifest["output_name"], device=device,
        cost_nodes=_dec(manifest["cost_nodes"]),
        per_layer_bits={k: tuple(v) for k, v in
                        _dec(manifest["per_layer_bits"]).items()},
        meta=meta)
    regenerated = _encode_stream(program)
    if regenerated != manifest["stream_pipelined"]:
        raise ArtifactError(
            f"artifact {ref[:12]}… fails the command-stream drift check: "
            "the stored per-MVU job list no longer matches what codegen "
            "derives from this Program — the artifact was produced by a "
            "different compiler build; recompile to refresh the store")
    # semantic verification, always on (a deserialized Program crossed a
    # trust boundary): integrity hashing catches bit rot, the verifier
    # catches a manifest that was tampered with *and* re-digested
    from repro_torch import analysis
    from repro_torch.analysis.verify_ir import VerifyError, verify_program
    analysis.count("artifact_load")
    try:
        verify_program(program, site="artifact_load")
    except VerifyError as e:
        raise ArtifactError(
            f"artifact {ref[:12]}… rejected by the program verifier "
            f"({e.check}): {e}") from e
    store._note_load((time.perf_counter() - t0) * 1e3)
    return program


# --------------------------------------------------------------------------
# recipe keys
# --------------------------------------------------------------------------

def recipe_digest(graph, calib, policy, per_layer=None, *,
                  route: str) -> str:
    """Deterministic digest of a compile recipe — the registry's lookup key
    into the store *before* it would call ``compile_graph``.

    Hashes the graph structure, every initializer's bytes, the calibration
    batch, the quant policy, per-layer overrides and the port's ``route``
    (``"torch:<device type>"``, in the slot of the reference's
    ``backend:interpret``, so the two packages' compiles of one recipe
    live under different keys). The artifact format version is folded in
    so a version bump cold-compiles rather than resolving to unreadable
    artifacts.
    """
    h = hashlib.sha256()
    h.update(f"{FORMAT}:{VERSION}".encode())
    h.update(graph.name.encode())
    for k, shape in sorted(graph.inputs.items()):
        h.update(f"{k}:{tuple(shape)}".encode())
    h.update(repr(sorted(graph.outputs)).encode())
    for n in graph.nodes:
        h.update(repr((n.name, n.op, tuple(n.inputs), n.output,
                       sorted(n.attrs.items()))).encode())
    for k in sorted(graph.initializers):
        h.update(k.encode())
        h.update(array_digest(graph.initializers[k]).encode())
    h.update(array_digest(calib).encode())
    h.update(repr(dataclasses.asdict(policy)
                  if dataclasses.is_dataclass(policy)
                  else policy).encode())
    h.update(repr(sorted((per_layer or {}).items())).encode())
    h.update(route.encode())
    return h.hexdigest()
