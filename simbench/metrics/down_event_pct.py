"""Share of the events the loop ran in a phase that parks a node's
threads, over the window: the program's ``events`` count, ``down``
(counted on the host from each bucket's phase edges and active rows and
the events each replica ran) over ``run``. Nothing where the program
keeps no ``down`` count or ran no event."""


def read(ctx):
    ev = ctx["stats"].get("events")
    if not ev or "down" not in ev or not ev.get("run"):
        return None
    return 100.0 * ev["down"] / ev["run"]
