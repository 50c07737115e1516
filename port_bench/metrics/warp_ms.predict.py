"""Device ms a predict call spends in the warp: the device time launched
inside the program's ``model/warp`` span (``warp_all_pairs``: every warp
of the fusion, V2VNet's re-warps of each round included)."""


def read(r):
    t = r.get("trace")
    if r.get("kind") != "predict" or t is None:
        return None
    dev = t.device_s("model/warp")
    return 1e3 * dev / r["profiled_calls"] if dev > 0 else None
