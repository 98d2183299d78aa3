"""Share of the window in the program's ``plan`` stage: the host's
making of the open loop's arrival plans, a part of ``issue``, host clock.
Nothing where the program has no such stage."""


def read(ctx):
    s = ctx["stats"]["seconds"].get("plan")
    return None if s is None else 100.0 * s / ctx["window_s"]
