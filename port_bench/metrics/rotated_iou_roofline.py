"""The rotated-IoU kernel's share of its roofline, in %: the least time of
the profiled calls' IoU launches (the larger of bytes over the HBM rate and
fp32 operations over the fp32 rate, counted from the boxes the ``iou=``
wrapper saw, clipping only the pairs whose reaches meet; ``core/peaks.py``)
over the device time launched in the benchmark's ``iou`` span."""

from port_bench.core.peaks import rotated_iou_bound_s


def read(r):
    t = r.get("trace")
    if r.get("kind") != "predict" or t is None or not r.get("iou_boxes"):
        return None
    dev = t.device_s("iou")
    if dev <= 0:
        return None
    return 100.0 * sum(rotated_iou_bound_s(b, b) for b in r["iou_boxes"]) / dev
