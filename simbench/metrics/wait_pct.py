"""Share of the window in the program's ``wait`` stage: the host blocked
until a dispatch's device work is done, host clock (0 on the CPU, whose
engine runs inside ``issue``). Nothing where the program has no such
stage."""


def read(ctx):
    s = ctx["stats"]["seconds"].get("wait")
    return None if s is None else 100.0 * s / ctx["window_s"]
