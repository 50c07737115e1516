"""Device ms a predict call spends around the model: kernels launched in
the call but outside the voxelize and model spans (the score split, top-k,
box decode, the IoU kernel and the suppression loop). Copies between host
and device are left out."""


def read(r):
    t = r.get("trace")
    if r.get("kind") != "predict" or t is None:
        return None
    dev = t.device_s("call", outside=("voxelize", "model"), exclude_cats=("gpu_memcpy",))
    return 1e3 * dev / r["profiled_calls"] if dev > 0 else None
