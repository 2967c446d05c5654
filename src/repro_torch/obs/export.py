"""Exporters: Chrome-trace/Perfetto JSON, Prometheus text exposition, and
a saved-trace summarizer.

The port's copy of ``repro/obs/export.py`` (pure Python, no torch).

Chrome trace format (Perfetto loads it directly): a flat list of complete
("ph":"X") events with microsecond ``ts``/``dur``. The clock domains map
onto *processes*:

* pid ``"wall"`` — one thread row per serving worker/phase; ``ts`` is
  ``t0_ns/1000`` rebased to the earliest span so traces start near 0;
* pid ``"virtual-cycles"`` — one thread row per bank/hart track; ``ts``
  is the virtual cycle count, abusing the µs unit as "cycles" (Perfetto
  renders the numbers; the unit label is wrong by design);
* pid ``"measured"`` — profiler-measured per-step spans (args carry
  ``domain="measured"``), laid end-to-end on their own synthetic
  timeline — passed in via ``extra_spans``.

Prometheus exposition is the text format v0.0.4 subset: HELP/TYPE plus
``name{labels} value`` lines, histograms expanded to cumulative
``_bucket``/``_sum``/``_count``. Several registries may be rendered into
one page (the spine shares one registry, stand-alone components own
theirs)."""

from __future__ import annotations

import json
import threading
from typing import Dict, Iterable, List

from repro_torch.obs.metrics import Histogram, MetricsRegistry
from repro_torch.obs.tracing import Span, Tracer

__all__ = ["chrome_trace", "write_chrome_trace", "prometheus_text",
           "trace_summary", "format_trace_summary", "start_metrics_server"]


# --------------------------------------------------------------- chrome trace

def chrome_trace(tracer: Tracer, *, extra_spans: Iterable[Span] = ()
                 ) -> Dict:
    events: List[Dict] = []
    measured, spans = [], []
    for s in list(tracer.spans()) + list(extra_spans):
        if (s.args or {}).get("domain") == "measured":
            measured.append(s)
        else:
            spans.append(s)
    wall = [s for s in spans if s.t1_ns > s.t0_ns or s.cycle_start is None]
    base_ns = min((s.t0_ns for s in wall), default=0)
    for s in measured:
        # third clock domain: profiler-measured step times on their own
        # synthetic end-to-end timeline (starts at 0 by construction)
        events.append({
            "name": s.name, "ph": "X", "pid": "measured",
            "tid": s.track or "steps",
            "ts": s.t0_ns / 1000.0,
            "dur": (s.t1_ns - s.t0_ns) / 1000.0,
            "args": dict(s.args),
        })
    for s in spans:
        args = dict(s.args)
        if s.trace_id:
            args["trace_id"] = s.trace_id
        if s.cycles is not None:
            args["cycles"] = s.cycles
        if s.t1_ns > s.t0_ns or s.cycle_start is None:
            events.append({
                "name": s.name, "ph": "X", "pid": "wall",
                "tid": s.track or f"req-{s.trace_id}",
                "ts": (s.t0_ns - base_ns) / 1000.0,
                "dur": (s.t1_ns - s.t0_ns) / 1000.0,
                "args": args,
            })
        if s.cycle_start is not None:
            # request-scoped spans get their own cycle row; tracker spans
            # (trace_id 0) keep their bank/hart occupancy track
            events.append({
                "name": s.name, "ph": "X", "pid": "virtual-cycles",
                "tid": (f"req-{s.trace_id}" if s.trace_id
                        else (s.track or "events")),
                "ts": float(s.cycle_start),
                "dur": float(max(s.cycle_end - s.cycle_start, 0)),
                "args": args,
            })
    events.sort(key=lambda e: (e["pid"], str(e["tid"]), e["ts"]))
    return {"traceEvents": events,
            "displayTimeUnit": "ms",
            "otherData": {"domains": {"wall": "perf_counter ns/1000",
                                      "virtual-cycles":
                                          "MVU cycles (ts unit = cycles)",
                                      "measured":
                                          "profiler wall ns/1000 "
                                          "(synthetic step timeline)"},
                          "tracer": tracer.stats()}}


def write_chrome_trace(tracer: Tracer, path: str, *,
                       extra_spans: Iterable[Span] = ()) -> str:
    with open(path, "w") as f:
        json.dump(chrome_trace(tracer, extra_spans=extra_spans), f)
    return path


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


# -------------------------------------------------------------- trace summary

#: canonical request phases, in spine order (used to order summary columns)
PHASES = ("queue", "schedule", "execute", "finalize")


def trace_summary(trace_json: Dict, *, top_k: int = 10) -> List[Dict]:
    """Digest a saved Chrome trace into the top-k slowest requests with a
    per-phase wall-time breakdown. Reads only the wall-domain events, so
    it works on any file :func:`write_chrome_trace` produced."""
    per_req: Dict[int, Dict] = {}
    for ev in trace_json.get("traceEvents", []):
        if ev.get("pid") != "wall" or ev.get("ph") != "X":
            continue
        tid = ev.get("args", {}).get("trace_id")
        if not tid:
            continue
        r = per_req.setdefault(tid, {"trace_id": tid, "phases": {},
                                     "total_us": 0.0, "cycles": 0})
        name = ev["name"]
        dur = float(ev.get("dur", 0.0))
        r["phases"][name] = r["phases"].get(name, 0.0) + dur
        if name in PHASES:
            r["total_us"] += dur
        cyc = ev.get("args", {}).get("cycles")
        if cyc and name != "decode_step":
            r["cycles"] += int(cyc)
    rows = sorted(per_req.values(), key=lambda r: -r["total_us"])[:top_k]
    return rows


def format_trace_summary(rows: List[Dict]) -> str:
    """Pretty table for ``python -m repro_torch.launch.serve trace``."""
    if not rows:
        return "(no request spans in trace)"
    names = list(PHASES) + sorted(
        {p for r in rows for p in r["phases"]} - set(PHASES))
    hdr = ["trace", "total_ms"] + [f"{n}_ms" for n in names] + ["cycles"]
    table = [hdr]
    for r in rows:
        table.append([str(r["trace_id"]), f"{r['total_us'] / 1000:.3f}"]
                     + [f"{r['phases'].get(n, 0.0) / 1000:.3f}"
                        for n in names]
                     + [str(r["cycles"])])
    widths = [max(len(row[i]) for row in table) for i in range(len(hdr))]
    lines = ["  ".join(c.rjust(w) for c, w in zip(row, widths))
             for row in table]
    lines.insert(1, "  ".join("-" * w for w in widths))
    return "\n".join(lines)


# ------------------------------------------------------------- metrics server

def start_metrics_server(port: int, registries, *,
                         extra_text=None) -> "threading.Thread":
    """Serve Prometheus text on ``/metrics`` from a daemon thread.

    ``registries`` may be a list or a zero-arg callable returning one (the
    service's registry set can grow as models bind). Returns the serving
    thread; the http server dies with the process (daemon)."""
    from http.server import BaseHTTPRequestHandler, HTTPServer

    def _regs():
        return registries() if callable(registries) else registries

    class Handler(BaseHTTPRequestHandler):
        def do_GET(self):  # noqa: N802 (stdlib API name)
            if self.path.rstrip("/") not in ("", "/metrics"):
                self.send_response(404)
                self.end_headers()
                return
            body = prometheus_text(_regs())
            if extra_text is not None:
                body += extra_text()
            data = body.encode()
            self.send_response(200)
            self.send_header("Content-Type",
                             "text/plain; version=0.0.4")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def log_message(self, *a):  # silence per-request stderr lines
            pass

    srv = HTTPServer(("127.0.0.1", port), Handler)
    t = threading.Thread(target=srv.serve_forever, daemon=True,
                         name=f"metrics-http-{port}")
    t.server = srv  # type: ignore[attr-defined]
    t.start()
    return t
