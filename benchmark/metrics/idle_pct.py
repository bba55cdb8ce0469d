"""idle_pct.<cell>: the device's idle share of the traced window, %: 100 x (1 -
the union of its kernels, copies and sets / the window), from
torch.profiler.  Left out where the profiler did not record every launch
the program's launch counters counted in the same window."""


def install(probe):
    pass


def read(run):
    t = run.traced
    if not t or not t["launches_match"] or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
