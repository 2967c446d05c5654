"""Prometheus text exposition of :class:`~repro_torch.obs.metrics.
MetricsRegistry` families.

The port's copy of the Prometheus half of ``repro/obs/export.py``: the
text format v0.0.4 subset, HELP/TYPE plus ``name{labels} value`` lines,
histograms expanded to cumulative ``_bucket``/``_sum``/``_count``. Several
registries may be rendered into one page. The Chrome-trace exporter, the
trace summary and the metrics HTTP server come with the serving runtime.
"""

from __future__ import annotations

from typing import List

from repro_torch.obs.metrics import Histogram, MetricsRegistry

__all__ = ["prometheus_text"]


# ----------------------------------------------------------------- prometheus

def _fmt_labels(key) -> str:
    if not key:
        return ""
    inner = ",".join(f'{k}="{v}"' for k, v in key)
    return "{" + inner + "}"


def _fmt_value(v: float) -> str:
    if v == float("inf"):
        return "+Inf"
    if isinstance(v, float) and v.is_integer():
        return str(int(v))
    return repr(v)


def prometheus_text(registries, *, prefix: str = "repro_") -> str:
    """Render one or many registries as Prometheus text exposition."""
    if isinstance(registries, MetricsRegistry):
        registries = [registries]
    lines: List[str] = []
    seen_headers = set()
    for reg in registries:
        for fam in reg.families():
            name = prefix + fam.name
            if name not in seen_headers:
                seen_headers.add(name)
                if fam.help:
                    lines.append(f"# HELP {name} {fam.help}")
                lines.append(f"# TYPE {name} {fam.kind}")
            if isinstance(fam, Histogram):
                for key, count in fam.items():
                    labels = dict(key)
                    counts = fam.bucket_counts(**labels)
                    cum = 0
                    for b, c in zip(fam.buckets, counts):
                        cum += c
                        lk = _fmt_labels(tuple(sorted(
                            {**labels, "le": _fmt_value(b)}.items())))
                        lines.append(f"{name}_bucket{lk} {cum}")
                    cum += counts[-1]
                    lk = _fmt_labels(tuple(sorted(
                        {**labels, "le": "+Inf"}.items())))
                    lines.append(f"{name}_bucket{lk} {cum}")
                    lines.append(f"{name}_sum{_fmt_labels(key)} "
                                 f"{_fmt_value(fam.sum(**labels))}")
                    lines.append(f"{name}_count{_fmt_labels(key)} "
                                 f"{int(count)}")
            else:
                for key, v in fam.items():
                    lines.append(f"{name}{_fmt_labels(key)} "
                                 f"{_fmt_value(v)}")
    return "\n".join(lines) + "\n"
