"""Observability: HPM-style counters, request tracing, exporters — the
port's copies of the reference's jax-free modules.

* :mod:`repro_torch.obs.metrics` — typed ``Counter``/``Gauge``/``Histogram``
  registry, the substrate every ``metrics()``/``stats()`` surface on the
  serving spine reads from;
* :mod:`repro_torch.obs.hpm` — the RISC-V HPM-counter-file analogue for the
  barrel controller: per-hart busy/xfer/issue/stall cycles with per-tag and
  per-precision attribution (``busy + xfer == SimReport.per_mvu_busy``);
* :mod:`repro_torch.obs.tracing` + :mod:`repro_torch.obs.export` —
  request-scoped spans in two clock domains (wall ns / virtual MVU
  cycles), bounded + sampled, exported as Perfetto-loadable Chrome trace
  JSON and Prometheus text.

* :mod:`repro_torch.obs.profiler` + :mod:`repro_torch.obs.calibrate` — the
  measured layer: per-step device time of a compiled Program beside the
  cycle model's prediction, and the fitted ns-per-virtual-cycle exchange
  rate that the slot scheduler books wall time with. Both are opt-in and
  exported lazily, so importing this package (as the serving path does)
  never imports the profiler.
"""

from repro_torch.obs.export import (chrome_trace, format_trace_summary,
                                    prometheus_text, start_metrics_server,
                                    trace_summary, write_chrome_trace)
from repro_torch.obs.hpm import HPMCounterFile, HPMCounters, precision_key
from repro_torch.obs.metrics import (DEFAULT_BUCKETS, Counter, Gauge,
                                     Histogram, MetricsRegistry)
from repro_torch.obs.tracing import Span, TraceContext, Tracer, now_ns

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "DEFAULT_BUCKETS",
    "HPMCounters", "HPMCounterFile", "precision_key",
    "Span", "TraceContext", "Tracer", "now_ns",
    "chrome_trace", "write_chrome_trace", "prometheus_text",
    "trace_summary", "format_trace_summary", "start_metrics_server",
    "ProgramProfile", "StepProfile", "profile_program", "format_profile",
    "Calibration", "fit", "fit_samples", "format_calibration",
]

_PROFILER = ("ProgramProfile", "StepProfile", "profile_program",
             "format_profile")
_CALIBRATE = ("Calibration", "fit", "fit_samples", "format_calibration")


def __getattr__(name):
    # lazy re-exports: the measured layer is opt-in, so the serving path
    # (which imports this package for its metrics) never loads it
    if name in _PROFILER:
        from repro_torch.obs import profiler
        return getattr(profiler, name)
    if name in _CALIBRATE:
        from repro_torch.obs import calibrate
        return getattr(calibrate, name)
    raise AttributeError(name)
