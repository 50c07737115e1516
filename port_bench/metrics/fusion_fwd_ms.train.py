"""Device ms a training step spends in the fusion's forward: the device
time launched inside the span around the model's ``_warp_and_fuse`` (the
backward runs on autograd's thread, outside it)."""


def read(r):
    t = r.get("trace")
    if r.get("kind") != "train" or t is None or not r.get("fusion_span"):
        return None
    dev = t.device_s("fusion")
    return 1e3 * dev / r["profiled_steps"] if dev > 0 else None
