"""Device ms a KD training step spends on its teacher's taps: the device
time launched inside the program's ``train/kd`` span (the rows of the KD
cache, or the teacher's forward without one)."""


def read(r):
    t = r.get("trace")
    if r.get("kind") != "train" or t is None:
        return None
    dev = t.device_s("train/kd")
    return 1e3 * dev / r["profiled_steps"] if dev > 0 else None
