"""Device ms a training step spends in its update: the device time
launched, from any thread, while the main thread held the program's
``train/update`` span (the gradient norm and Adam)."""


def read(r):
    t = r.get("trace")
    if r.get("kind") != "train" or t is None:
        return None
    dev = t.device_s_during("train/update")
    return 1e3 * dev / r["profiled_steps"] if dev > 0 else None
