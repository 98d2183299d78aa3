"""Share of the lock operations the event loop began on the loopback
tier, over the window: the program's ``events`` count, ``loop`` (hlock's
operations on a lock of another node in the taker's rack, whose lock
steps ride the NIC's loopback path) over ``ops`` (every lock operation
begun). Nothing where the program keeps no ``loop`` count or began no
operation."""


def read(ctx):
    ev = ctx["stats"].get("events")
    if not ev or "loop" not in ev or not ev.get("ops"):
        return None
    return 100.0 * ev["loop"] / ev["ops"]
