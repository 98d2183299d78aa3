"""Share of the window in the program's ``issue`` stage: the host's
enqueueing of each shard (operand upload, draw stream, arrival plan, K1's
launch), host clock. Nothing where the program has no such stage."""


def read(ctx):
    s = ctx["stats"]["seconds"].get("issue")
    return None if s is None else 100.0 * s / ctx["window_s"]
