"""Share of the window in the program's ``aggregate`` stage: host copy-back
and results after each bucket's device work."""


def read(ctx):
    return 100.0 * ctx["stats"]["seconds"]["aggregate"] / ctx["window_s"]
