"""Share of the timed window in which no operation ran on the device, in
%: 1 - (device-busy seconds per step) / (the window's seconds per step).

The busy seconds are the union of the device operations' intervals in a
phase of the mix's ``profile_steps`` steps, traced with CUDA activity alone;
the seconds per step are the untraced window's, so the profiler's own host
work, which stretches a traced step, does not count as idle."""


def read(r):
    t = r.get("device_trace")
    if r.get("kind") != "train" or t is None or t.busy_s <= 0 or not r.get("timed_steps"):
        return None
    busy = t.busy_s / r["profiled_steps"]
    return 100.0 * (1.0 - busy / (r["timed_window_s"] / r["timed_steps"]))
