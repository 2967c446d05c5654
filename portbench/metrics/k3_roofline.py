"""``k3_roofline``: K3's least time for the traced round's projections over
K3's device time in the trace, in %.

The device time is every kernel named ``bitserial_gemm_kernel<false``
(K3, ``kernels/csrc/bitserial_matmul.cu``; K4 is the ``<true`` one). The
work is logical (``portbench/work/lm.py``): one call per projection per
prefill at the prompt's true rows, one per projection per decode step at
the rows that held a request, each bounded by the larger of its
operations over the int8 peak and its bytes over HBM's. Padding to a
bucket and idle arena rows are not work.
"""

from portbench.work import lm, peaks

KERNEL = r"bitserial_gemm_kernel<false"


def read(run):
    sl = run.slice
    if sl is None or sl.complete is False:
        return None
    count, seconds = sl.kernels(KERNEL)
    if not count or not seconds:
        return None
    w = sl.work
    sv = run.config["serving"]
    wb, ab = int(sv["w_bits"]), int(sv["a_bits"])
    layers = lm.dims(run.config)["layers"]

    def bound(m):
        return layers * sum(
            peaks.bound_seconds(*lm.proj_call(m, k, n, wb, ab, bias))
            for _, k, n, bias in lm.projections(run.config))

    total = sum(bound(p) for p in w["prompts"])
    if w["decode_steps"]:
        total += w["decode_steps"] * bound(w["slot_steps"] / w["decode_steps"])
    return 100.0 * total / seconds
