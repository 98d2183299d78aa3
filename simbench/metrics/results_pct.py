"""Share of the window in the program's ``results`` stage: the host's
latency pools, percentiles and serving summaries of the jobs'
``BatchResult``s, host clock. Nothing where the program has no such
stage."""


def read(ctx):
    s = ctx["stats"]["seconds"].get("results")
    return None if s is None else 100.0 * s / ctx["window_s"]
