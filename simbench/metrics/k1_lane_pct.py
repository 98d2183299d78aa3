"""Share of the events the loop ran on K1's owner-lane body (the closed
loop at up to 256 threads: each thread stepped on the lane that owns it,
the argmin keys in registers), over the window: the program's ``events``
count, ``lane`` (counted on the host from each bucket's shape and the
events its replicas ran) over ``run``. Nothing where the program keeps no
``lane`` count or ran no event."""


def read(ctx):
    ev = ctx["stats"].get("events")
    if not ev or "lane" not in ev or not ev.get("run"):
        return None
    return 100.0 * ev["lane"] / ev["run"]
