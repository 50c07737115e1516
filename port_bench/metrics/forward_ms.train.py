"""Device ms a training step spends in its forward: the device time
launched inside the program's ``train/forward`` span (the student's
forward and the losses; the KD rows lie outside it, in ``train/kd``)."""


def read(r):
    t = r.get("trace")
    if r.get("kind") != "train" or t is None:
        return None
    dev = t.device_s("train/forward")
    return 1e3 * dev / r["profiled_steps"] if dev > 0 else None
