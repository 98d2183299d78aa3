"""The port's ``lower()`` against the reference's, field by field.

For every registered scenario and every workload it sweeps (open-loop ones
included — lowering is ported whole) the 16 operand rows must be equal
with tolerance zero: ``np.array_equal`` plus dtype and shape.
"""
import numpy as np
import pytest

import torch_ref as R
from repro_torch.core.batch import shape_key
from repro_torch.workloads import (OPERAND_DTYPES, WorkloadOperands, lower,
                                   operands_from_numpy, pad_phases)

N_EVENTS = 3000
CASES = [(name, i) for name in R.ref_registry.scenario_names()
         for i in range(len(R.ref_registry.scenario_workloads(name) or []))]


def _pair(name, i):
    ref_w = R.ref_registry.scenario_workloads(name)[i]
    return ref_w, R.to_port(ref_w)


def test_every_simulator_scenario_is_covered():
    assert len(CASES) >= 40
    assert {n for n, _ in CASES} >= {"paper-fig5", "node-churn",
                                     "open-loop-ramp", "read-heavy",
                                     "rack-locality", "fail-slow-cascade"}


@pytest.mark.parametrize("name,i", CASES)
def test_lower_rows_equal_reference(name, i):
    ref_w, port_w = _pair(name, i)
    ref_lw = R.ref_workloads.lower(ref_w, N_EVENTS)
    port_lw = lower(port_w, N_EVENTS)
    assert port_lw.shape_key == ref_lw.shape_key
    assert shape_key(port_w, N_EVENTS) == R.ref_batch.shape_key(
        ref_w, N_EVENTS) == ref_lw.shape_key
    assert WorkloadOperands._fields == type(ref_lw.operands)._fields
    R.assert_bitwise(list(ref_lw.operands), list(port_lw.operands),
                     WorkloadOperands._fields)
    for f in WorkloadOperands._fields:
        assert np.asarray(getattr(port_lw.operands, f)).dtype \
            == OPERAND_DTYPES[f]


@pytest.mark.parametrize("name", ["node-churn", "open-loop-ramp",
                                  "read-heavy"])
def test_pad_phases_equal_reference(name):
    ref_w, port_w = _pair(name, 1)
    ref_o = R.ref_workloads.pad_phases(
        R.ref_workloads.lower(ref_w, N_EVENTS).operands, 5)
    port_o = pad_phases(lower(port_w, N_EVENTS).operands, 5)
    R.assert_bitwise(list(ref_o), list(port_o), WorkloadOperands._fields)


@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("as_dict", [False, True])
def test_operands_from_numpy_round_trips(batched, as_dict):
    ref_w = R.ref_registry.scenario_workloads("fail-slow-cascade")[1]
    ops = R.ref_workloads.lower(ref_w, N_EVENTS).operands
    leaves = [np.asarray(a) for a in ops]
    if batched:
        leaves = [np.stack([a, a]) for a in leaves]
    fields = (dict(zip(WorkloadOperands._fields, leaves)) if as_dict
              else tuple(leaves))
    out = operands_from_numpy(fields, "cpu")
    assert isinstance(out, WorkloadOperands)
    R.assert_bitwise(leaves, list(out), WorkloadOperands._fields)


def test_operands_from_numpy_refuses_a_drifted_dtype():
    ref_w = R.ref_registry.scenario_workloads("paper-fig5")[0]
    leaves = [np.asarray(a)
              for a in R.ref_workloads.lower(ref_w, N_EVENTS).operands]
    leaves[2] = leaves[2].astype(np.int64)          # edges
    with pytest.raises(TypeError, match="edges"):
        operands_from_numpy(tuple(leaves), "cpu")
    with pytest.raises(ValueError, match="16"):
        operands_from_numpy(tuple(leaves[:-1]), "cpu")
