"""``mfu.cnn``: the logical work of every image whose logits reached the
host inside the window (``portbench/work/cnn.py``: conv0, the eight packed
convs, the fc) over the window's seconds, as a share of one H100's dense
int8 peak, in %."""

from portbench.work import cnn, peaks


def read(run):
    images = run.counter_delta("images")
    return (100.0 * cnn.image_flops(run.config) * images / run.seconds
            / peaks.INT8_OPS)
