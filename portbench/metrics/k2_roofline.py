"""``k2_roofline``: K2's least time for the traced slice's forwards over
K2's device time in the trace, in %.

The device time is every kernel named ``bitserial_conv2d_kernel`` (K2,
``kernels/csrc/bitserial_conv.cu``); each forward makes one call per
packed conv, so the slice held (K2 kernels / convs) forwards. The work is
logical (``portbench/work/cnn.py``): each conv at the batch's shapes,
bounded by the larger of its operations over the int8 peak and its bytes
over HBM's.
"""

from portbench.work import cnn, peaks

KERNEL = r"bitserial_conv2d_kernel"


def read(run):
    sl = run.slice
    if sl is None:
        return None
    count, seconds = sl.kernels(KERNEL)
    if not count or not seconds:
        return None
    cfg = run.config
    calls = cnn.conv_calls(cfg, int(sl.work["batch"]))
    per_forward = sum(peaks.bound_seconds(*cnn.conv_call_work(
        c, int(cfg["w_bits"]), int(cfg["a_bits"]))) for c in calls)
    return 100.0 * per_forward * (count / len(calls)) / seconds
