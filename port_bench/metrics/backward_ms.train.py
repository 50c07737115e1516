"""Device ms a training step spends in its backward: the device time
launched, from any thread, while the main thread held the program's
``train/backward`` span (``zero_grad`` and ``loss.backward()``, whose
operations autograd's thread launches while the main thread waits)."""


def read(r):
    t = r.get("trace")
    if r.get("kind") != "train" or t is None:
        return None
    dev = t.device_s_during("train/backward")
    return 1e3 * dev / r["profiled_steps"] if dev > 0 else None
