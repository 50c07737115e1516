"""Device ms a predict call spends in the fusion: the device time launched
inside the span around the model's ``_warp_and_fuse`` (warp and fuse)."""


def read(r):
    t = r.get("trace")
    if r.get("kind") != "predict" or t is None or not r.get("fusion_span"):
        return None
    dev = t.device_s("fusion")
    return 1e3 * dev / r["profiled_calls"] if dev > 0 else None
