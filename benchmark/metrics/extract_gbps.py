"""extract_gbps: logical GB/s of the window's extract operations (records x 2 *
samples x 4 B each), all of them over the time from the window's start to
the last completion."""


def read(run):
    return run.rate_gbps()
