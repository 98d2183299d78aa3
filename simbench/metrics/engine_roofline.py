"""The draws and the event loop against their roofline: the least time
the card needs for the closed-loop work of the traced stretch's jobs
(``peaks.least_seconds``) over the time an operation ran on the device
in that stretch (``torch.profiler``; the draws, K1 and the copies of
their operands and outputs). Nothing without a trace, nor for open-loop
work, whose events the data needs are not counted yet."""
from simbench import peaks


def read(ctx):
    t = ctx["trace"]
    if not t:
        return None
    ws = [w for job in t["jobs"] for w in job]
    if not ws or any(w.get("arrivals") for w in ws):
        return None
    cfg = ctx["config"]
    least = peaks.least_seconds(ws, cfg["n_seeds"], cfg["n_events"])
    return 100.0 * least / t["busy_s"]
