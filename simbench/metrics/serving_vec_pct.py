"""Share of the seeds whose serving summaries the program took in its one
vectorised pass over a result's seeds, over the window: the program's
``serving`` count, ``seeds`` over ``seeds`` plus ``fallback`` (the seeds
its 2**53 guard summarised one by one). Nothing where the program has no
such count or summarised nothing."""


def read(ctx):
    sv = ctx["stats"].get("serving")
    if not sv or not sv["seeds"] + sv["fallback"]:
        return None
    return 100.0 * sv["seeds"] / (sv["seeds"] + sv["fallback"])
