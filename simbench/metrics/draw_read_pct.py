"""Share of the drawn events at which the event loop read its draws, over
the window: the program's ``events`` count, ``ops`` (the lock operations
the loop began, its non-critical-section steps: the only events whose
draws it reads) over ``drawn`` (replicas x events, for which the draw
stream is made). Nothing where the program has no such count or drew
nothing."""


def read(ctx):
    ev = ctx["stats"].get("events")
    if not ev or "ops" not in ev or not ev["drawn"]:
        return None
    return 100.0 * ev["ops"] / ev["drawn"]
