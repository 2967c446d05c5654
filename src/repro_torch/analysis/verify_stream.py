"""Command-stream hazard / resource analyzer.

A :class:`~repro_torch.core.codegen.CommandStream` is the paper's executable
artifact: an ordered list of CSR job images the barrel controller issues to
the MVUs. :func:`verify_stream` checks the static properties every
consumer (simulator, real executor, slot scheduler) assumes:

* **hazard ordering** — every ``depends_on`` edge points strictly
  backwards (the controller issues in list order, so a forward edge is a
  reordered/racy stream: the RAW/WAW guarantee);
* **tag uniqueness** — non-empty job tags are unique (HPM attribution and
  trace spans key on them);
* **illegal jobs** — HOST jobs placed on an MVU, XFER jobs explicitly
  transferring to themselves, compute jobs with zero-size tile geometry
  or precisions outside the MVU's [1, 8] serial range;
* **cycle accounting** (``reconcile=True``) — a
  :meth:`BarrelController.simulate` run must book exactly the cycles the
  jobs declare: per-hart ``busy + xfer`` HPM counters equal
  ``per_mvu_busy``, per-hart job-cycle sums (under ``cycle_scale``) match,
  and no job starts before its dependencies end.

The port's copy of ``repro/analysis/verify_stream.py`` (pure Python).
"""

from __future__ import annotations

from typing import Optional

from repro_torch.analysis.verify_ir import VerifyError

__all__ = ["StreamError", "verify_stream"]


class StreamError(VerifyError):
    """A command-stream invariant violation (see module docstring)."""


def _blame(i, job) -> str:
    return f"job {i} ({job.tag or job.op.value})"


def verify_stream(stream, *, controller=None, xfer_cycles_per_job: int = 64,
                  cycle_scale: int = 1, reconcile: bool = True,
                  blame: Optional[str] = None):
    """Statically check one stream; returns the reconciliation
    :class:`~repro_torch.runtime.controller.SimReport` (or ``None`` when
    ``reconcile=False``). Raises :class:`StreamError` on the first
    violation, blaming the offending job."""
    from repro_torch.core.mvu import MVU_COUNT, OpKind

    jobs = stream.jobs
    seen_tags = {}
    for i, job in enumerate(jobs):
        who = blame or _blame(i, job)
        for d in job.depends_on:
            if not isinstance(d, int) or not 0 <= d < i:
                raise StreamError(
                    "hazard-order",
                    f"{_blame(i, job)} depends on job {d!r}, which does "
                    "not strictly precede it — the in-order controller "
                    "would issue it against stale data", blame=who)
        if job.tag:
            if job.tag in seen_tags:
                raise StreamError(
                    "tag-duplicate",
                    f"{_blame(i, job)} reuses tag {job.tag!r} of job "
                    f"{seen_tags[job.tag]} — HPM/trace attribution would "
                    "merge them", blame=who)
            seen_tags[job.tag] = i
        if job.op == OpKind.HOST:
            if job.mvu >= 0:
                raise StreamError(
                    "host-on-mvu",
                    f"{_blame(i, job)} is HOST work placed on MVU "
                    f"{job.mvu} — it would book fabric cycles it never "
                    "spends", blame=who)
            continue
        if not 0 <= job.mvu < MVU_COUNT:
            raise StreamError(
                "mvu-range",
                f"{_blame(i, job)} targets MVU {job.mvu} outside "
                f"[0, {MVU_COUNT})", blame=who)
        if job.op == OpKind.XFER:
            # dest_mvu=None is the legal implicit destination (MVUJob
            # documents None = self/next-stage); only an *explicit*
            # self-transfer is a dead job
            if job.dest_mvu is not None and job.dest_mvu == job.mvu:
                raise StreamError(
                    "xfer-self",
                    f"{_blame(i, job)} transfers MVU {job.mvu} to itself "
                    "— a zero-distance (dead) transfer", blame=who)
            continue
        if not (1 <= job.a_bits <= 8 and 1 <= job.w_bits <= 8):
            raise StreamError(
                "precision-range",
                f"{_blame(i, job)} asks A{job.a_bits}/W{job.w_bits}, "
                "outside the MVU's [1, 8] serial range", blame=who)
        if job.m_tiles < 1 or job.k_tiles < 1 or job.n_outputs < 1:
            raise StreamError(
                "zero-size-job",
                f"{_blame(i, job)} has zero-size tile geometry "
                f"(m_tiles={job.m_tiles} k_tiles={job.k_tiles} "
                f"n_outputs={job.n_outputs})", blame=who)

    if not reconcile:
        return None
    if controller is None:
        from repro_torch.runtime.controller import BarrelController
        controller = BarrelController()
    rep = controller.simulate(stream, xfer_cycles_per_job,
                              cycle_scale=cycle_scale)
    harts = controller.harts
    expect = [0] * harts
    for i, job in enumerate(jobs):
        if job.op == OpKind.HOST:
            continue
        dur = (xfer_cycles_per_job if job.op == OpKind.XFER
               else job.cycles) * cycle_scale
        expect[job.mvu % harts] += dur
        for d in job.depends_on:
            if rep.per_job_end[d] > rep.per_job_start[i]:
                raise StreamError(
                    "schedule-order",
                    f"{_blame(i, job)} starts at cycle "
                    f"{rep.per_job_start[i]}, before its dependency "
                    f"{d} ends at {rep.per_job_end[d]}",
                    blame=blame or _blame(i, job))
    hpm = rep.hpm
    for h in range(harts):
        if expect[h] != rep.per_mvu_busy[h]:
            raise StreamError(
                "cycle-accounting",
                f"hart {h}: jobs declare {expect[h]} cycles but the "
                f"simulator booked {rep.per_mvu_busy[h]}",
                blame=blame or f"hart {h}")
        if hpm is not None and hpm.busy[h] + hpm.xfer[h] != \
                rep.per_mvu_busy[h]:
            raise StreamError(
                "hpm-accounting",
                f"hart {h}: HPM busy+xfer = "
                f"{hpm.busy[h] + hpm.xfer[h]} != per_mvu_busy "
                f"{rep.per_mvu_busy[h]}", blame=blame or f"hart {h}")
    return rep
