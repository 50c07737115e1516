"""Device ms a predict call spends in the backbone and heads: the device
time launched inside the model's forward span and outside the fusion's."""


def read(r):
    t = r.get("trace")
    if r.get("kind") != "predict" or t is None:
        return None
    dev = t.device_s("model", outside=("fusion",))
    return 1e3 * dev / r["profiled_calls"] if dev > 0 else None
