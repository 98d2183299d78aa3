"""Share of the drawn events that the event loop ran, over the window:
the program's ``events`` count, ``run`` (K1's per-replica ``diag``; a
closed replica runs every event) over ``drawn`` (replicas x events, for
which the draw stream is made). Nothing where the program has no such
count or drew nothing."""


def read(ctx):
    ev = ctx["stats"].get("events")
    if not ev or not ev["drawn"]:
        return None
    return 100.0 * ev["run"] / ev["drawn"]
