"""Open-loop traffic: arrival streams, queueing, serving metrics.

``repro_torch.traffic`` turns the closed-loop lock simulator into a lock
*service* under offered load: ``repro_torch.workloads.Arrivals`` specs
lower to ``arr_*`` operand rows, :mod:`repro_torch.traffic.stream`
precomputes the per-request arrival plan the event loop consumes, and
:mod:`repro_torch.traffic.metrics` reduces the per-request outputs
(arrival / wait / sojourn / status) to goodput, latency percentiles, drop
accounting and saturation knees. See ``docs/serving.md`` for the model.
"""
from repro_torch.traffic.metrics import (COMPLETED, DROPPED, IN_SERVICE,
                                         PENDING, detect_knee,
                                         serving_summary)
from repro_torch.traffic.stream import (ArrivalPlan, arrival_gaps,
                                        arrival_plan, arrival_times_i64,
                                        arrival_times_pairs, fma_f32,
                                        log1p_f32, per_request,
                                        request_phase_onehot, token_admit)

__all__ = [
    "ArrivalPlan", "COMPLETED", "DROPPED", "IN_SERVICE", "PENDING",
    "arrival_gaps", "arrival_plan", "arrival_times_i64",
    "arrival_times_pairs", "detect_knee",
    "fma_f32", "log1p_f32", "per_request", "request_phase_onehot",
    "serving_summary", "token_admit",
]
