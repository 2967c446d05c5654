"""Typed metrics registry: ``Counter`` / ``Gauge`` / ``Histogram`` with
labels — the unified substrate the serving spine's ``metrics()``/``stats()``
surfaces read from.

The port's copy of ``repro/obs/metrics.py`` (pure Python, no torch).

Design constraints (this is hot-path instrumentation, not a dashboard):

* **cheap writes** — ``inc``/``set``/``observe`` are one dict update under
  the GIL; no lock is taken on the write path ("lock-free-ish": concurrent
  writers may lose an increment across a context switch, which is the
  standard metrics trade-off — totals drive dashboards, not invariants.
  Every counter that *is* an invariant in tests is only written under the
  owning component's existing lock, so those stay exact);
* **near-zero cost when disabled** — a disabled registry short-circuits
  every mutator on one attribute check and allocates nothing;
* **consistent reads** — ``snapshot()``/``collect()`` copy each family's
  value dict, so exporters never observe a half-written histogram.

Label values are passed as keyword arguments and keyed by a sorted item
tuple, so ``c.inc(variant="m@W2A2")`` and the no-label ``c.inc()`` live in
the same family. Families are idempotent per registry: asking for an
existing name returns the same object (type-checked), which is what lets
several components share one spine-wide registry without coordination.

Prometheus text exposition lives in
:func:`repro_torch.obs.export.prometheus_text`; this module only owns the
data model.
"""

from __future__ import annotations

import math
import threading
from typing import Dict, Iterable, List, Optional, Tuple

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "DEFAULT_BUCKETS"]

#: default histogram buckets (seconds-flavoured, log-ish spread) — callers
#: with cycle- or byte-valued histograms pass their own.
DEFAULT_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                   0.25, 0.5, 1.0, 2.5, 5.0, 10.0)

_NO_LABELS: Tuple = ()


def _label_key(labels: Dict) -> Tuple:
    if not labels:
        return _NO_LABELS
    return tuple(sorted(labels.items()))


class _Metric:
    """Shared family plumbing: name, help text, per-label-set values."""

    kind = "untyped"

    def __init__(self, name: str, help: str, registry: "MetricsRegistry"):
        self.name = name
        self.help = help
        self._registry = registry
        self._values: Dict[Tuple, float] = {}

    @property
    def enabled(self) -> bool:
        return self._registry.enabled

    def value(self, **labels) -> float:
        return self._values.get(_label_key(labels), 0.0)

    def items(self) -> List[Tuple[Tuple, float]]:
        """[(label_items_tuple, value)] — a copied, consistent view."""
        return list(self._values.items())

    def clear(self) -> None:
        self._values = {}


class Counter(_Metric):
    """Monotonically increasing total."""

    kind = "counter"

    def inc(self, amount: float = 1, **labels) -> None:
        if not self._registry.enabled:
            return
        k = _label_key(labels)
        vals = self._values
        vals[k] = vals.get(k, 0) + amount


class Gauge(_Metric):
    """Point-in-time value (``set``) with a max-tracking helper for
    peak-style gauges (queue high-water marks)."""

    kind = "gauge"

    def set(self, value: float, **labels) -> None:
        if not self._registry.enabled:
            return
        self._values[_label_key(labels)] = value

    def set_max(self, value: float, **labels) -> None:
        if not self._registry.enabled:
            return
        k = _label_key(labels)
        vals = self._values
        if value > vals.get(k, float("-inf")):
            vals[k] = value

    def inc(self, amount: float = 1, **labels) -> None:
        if not self._registry.enabled:
            return
        k = _label_key(labels)
        vals = self._values
        vals[k] = vals.get(k, 0) + amount


class Histogram(_Metric):
    """Fixed-bucket histogram: per-label-set cumulative bucket counts,
    count and sum. ``value()`` returns the observation count (so histogram
    families still answer the generic read API)."""

    kind = "histogram"

    def __init__(self, name: str, help: str, registry: "MetricsRegistry",
                 buckets: Iterable[float] = DEFAULT_BUCKETS):
        super().__init__(name, help, registry)
        self.buckets = tuple(sorted(buckets))
        # label key -> [bucket counts..., +Inf count]
        self._bucket_counts: Dict[Tuple, List[int]] = {}
        self._sums: Dict[Tuple, float] = {}

    def observe(self, value: float, **labels) -> None:
        if not self._registry.enabled:
            return
        k = _label_key(labels)
        counts = self._bucket_counts.get(k)
        if counts is None:
            counts = self._bucket_counts[k] = [0] * (len(self.buckets) + 1)
            self._sums.setdefault(k, 0.0)
        # linear scan: bucket lists are short and this avoids bisect import
        # costs dominating tiny observations
        for i, b in enumerate(self.buckets):
            if value <= b:
                counts[i] += 1
                break
        else:
            counts[len(self.buckets)] += 1
        self._sums[k] = self._sums.get(k, 0.0) + value
        self._values[k] = self._values.get(k, 0) + 1   # observation count

    def sum(self, **labels) -> float:
        return self._sums.get(_label_key(labels), 0.0)

    def bucket_counts(self, **labels) -> List[int]:
        """Per-bucket (non-cumulative) counts incl. the +Inf overflow."""
        return list(self._bucket_counts.get(
            _label_key(labels), [0] * (len(self.buckets) + 1)))

    def quantile(self, q: float, **labels) -> float:
        """Bucket-interpolated quantile (upper bound of the target bucket)
        — coarse by construction; exact percentiles stay with the callers
        that keep raw deques."""
        counts = self.bucket_counts(**labels)
        total = sum(counts)
        if total == 0:
            return 0.0
        target = math.ceil(q * total)
        seen = 0
        for i, c in enumerate(counts):
            seen += c
            if seen >= target:
                return (self.buckets[i] if i < len(self.buckets)
                        else float("inf"))
        return float("inf")


class MetricsRegistry:
    """A named set of metric families.

    One registry per observability domain (the reference's serving spine
    shares one through its ``InferenceService``); components constructed
    stand-alone create their own, and exporters can render several
    registries into one exposition
    (:func:`repro_torch.obs.export.prometheus_text` takes a list).
    """

    def __init__(self, *, enabled: bool = True):
        self.enabled = enabled
        self._families: Dict[str, _Metric] = {}
        # family registration is rare; guard it so two threads racing to
        # create the same family converge on one object
        self._reg_lock = threading.Lock()

    def disable(self) -> None:
        self.enabled = False

    def enable(self) -> None:
        self.enabled = True

    def _family(self, cls, name: str, help: str, **kw) -> _Metric:
        fam = self._families.get(name)
        if fam is None:
            with self._reg_lock:
                fam = self._families.get(name)
                if fam is None:
                    fam = cls(name, help, self, **kw)
                    self._families[name] = fam
        if not isinstance(fam, cls):
            raise TypeError(f"metric {name!r} already registered as "
                            f"{fam.kind}, not {cls.kind}")
        return fam

    def counter(self, name: str, help: str = "") -> Counter:
        return self._family(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._family(Gauge, name, help)

    def histogram(self, name: str, help: str = "",
                  buckets: Iterable[float] = DEFAULT_BUCKETS) -> Histogram:
        return self._family(Histogram, name, help, buckets=buckets)

    def get(self, name: str) -> Optional[_Metric]:
        return self._families.get(name)

    def families(self) -> List[_Metric]:
        return list(self._families.values())

    def snapshot(self) -> Dict[str, Dict]:
        """{name: {"kind", "help", "values": {label_repr: value}}} — a
        plain-dict copy safe to serialize or diff in tests."""
        out = {}
        for fam in self.families():
            vals = {}
            for k, v in fam.items():
                label = ",".join(f"{a}={b}" for a, b in k) if k else ""
                vals[label] = v
            out[fam.name] = {"kind": fam.kind, "help": fam.help,
                             "values": vals}
        return out
