"""Share of the traced stretch in which no operation ran on the device:
one less the union of the device's operation intervals (``torch.profiler``)
over the stretch's length on the host clock; gaps between jobs count as
idle. Nothing without a trace."""


def read(ctx):
    t = ctx["trace"]
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"]) if t else None
