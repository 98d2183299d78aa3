"""The check fails what it must: the control (the reference in bfloat16
in the program's place) and a run whose timed path is broken underneath
come out not correct; the reference in f32 in the same place passes."""
import json
import time

import pytest

from simbench import check, control, harness, inputs
from simbench.tests import tiny


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    harness.WARM_EVENTS, warm = 20, harness.WARM_EVENTS
    yield tiny.make(tmp_path_factory.mktemp("bench"))
    harness.WARM_EVENTS = warm


@pytest.fixture(scope="module")
def long_tree(tmp_path_factory):
    """Long enough runs that a lower precision shows on every seed; only
    the reference runs here."""
    return tiny.make(tmp_path_factory.mktemp("long"), n_events=600)


class _F32(control.LowPrecision):
    def replicas(self, keys):
        todo = [k for k in dict.fromkeys(keys) if k not in self.cache]
        reps = check.reference_replicas(
            [(json.loads(d), s, self.config["n_events"]) for d, s in todo],
            1)
        self.cache.update(zip(todo, reps))
        return [self.cache[k] for k in keys]


def _judge(root, cell, seed, kind):
    c = inputs.cell(root, cell)
    prog = kind(c["config"], 1)
    sampler = harness.Sampler(seed, c["config"], prog)
    for _, (j, ws) in zip(range(3),
                           inputs.jobs(c["config"], c["traffic"], seed)):
        sampler.offer(j, prog.run_job(ws))
    judged = check.judge(prog.resolve(sampler.sample()), c["config"], 1)
    judged.pop("replicas_checked")
    return judged


@pytest.mark.parametrize("cell", ["fig5-grid", "open-ramp"])
def test_bfloat16_control_fails_every_seed(long_tree, cell):
    for seed in (3, 2**31 + 5, 77):
        got = _judge(long_tree, cell, seed, control.LowPrecision)
        assert got["replica_values_differing"][0] > 0
        assert check.verdict(got, 0, 3) is False
        f32 = _judge(long_tree, cell, seed, _F32)
        assert f32["replica_values_differing"] == (0, 0)
        assert check.verdict(f32, 0, 3) is True


def _run(root, cell="fig5-jobs"):
    return harness.run_cell(root, cell, 2**31 + 3, 0.01, False, "cpu",
                            time.perf_counter())


def test_state_left_unchanged_fails(tree, monkeypatch):
    from repro_torch.core import batch
    orig = batch.run_events

    def stuck(alg, T, N, K, n_events, *a, **k):
        return orig(alg, T, N, K, 0, *a, **k)
    monkeypatch.setattr(batch, "run_events", stuck)
    r = _run(tree)
    assert r["correct"] is False
    assert r["checks"]["replica_values_differing"]["value"] > 0


def test_answer_altered_where_produced_fails(tree, monkeypatch):
    from repro_torch.core import batch
    orig = batch.run_events

    def altered(*a, **k):
        out = orig(*a, **k)
        out[0][:, 0] += 1
        return out
    monkeypatch.setattr(batch, "run_events", altered)
    r = _run(tree)
    assert r["correct"] is False
    assert r["checks"]["replica_values_differing"]["value"] > 0


def test_mean_over_half_the_seeds_fails(tree, monkeypatch):
    from repro_torch.core.batch import BatchResult
    monkeypatch.setattr(BatchResult, "mean_mops", property(
        lambda self: float(self.throughput_mops[
            :max(1, len(self.seeds) // 2)].mean())))
    r = _run(tree)
    assert r["correct"] is False
    assert r["checks"]["aggregate_values_differing"]["value"] > 0
