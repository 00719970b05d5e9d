"""The simulator cell's check, driven whole on the CPU at a small size:
a sound program is judged correct; the control and each fault planted
in the timed path are judged not correct.  (The cell runs on one chip:
it has no exchange between chips to leave out.)"""

import pytest
import torch

from kwokbench import run, spec
from kwokbench.outcome import Ctx

SCALE = {"pods": 2048, "nodes": 32}
SEED = 3_000_000_007  # past 32 signed bits, as the checks' seeds are


def run_cell(seed=SEED, control=False, trace=False):
    cell = spec.load_cell("chaos-10k.sim")
    ctx = Ctx(cell, seed, 0.3, trace, device="cpu", scale=SCALE, control=control)
    res = spec.driver(cell).run(ctx)
    line = run.result_line(ctx, res, {"platform": "cpu"})
    assert line["correct"] == res.correct and list(line)[-1] == "checks"
    return res


def test_sound_program_is_correct():
    res = run_cell()
    assert res.correct and res.attempted > 0 and res.failed == 0
    assert {name for name, _, _ in res.checks} == {"pod_stage_mismatches",
                                                    "node_stage_mismatches"}


def test_traced_run_is_correct_and_counts():
    res = run_cell(seed=SEED + 10, trace=True)
    assert res.correct
    assert res.layer["tick_collect"][0]["rematches"] > 0


def test_control_fails():
    """The reference one precision below (bfloat16 draws) in the
    program's place: its fired stages differ from the reference's."""
    res = run_cell(control=True)
    assert res.correct
    readings = dict(res.control)
    assert readings["pod_stage_mismatches"] > 0


def impl_patch(monkeypatch, fault):
    from kwok_tpu_torch.ops import tick as T

    real = T._run_ticks_collect_impl

    def broken(params, soa, dt_ms, num_ticks):
        n = soa.features.shape[0]
        if fault == "unchanged":
            # the step hands its state back unchanged and fires nothing
            empty = torch.full((num_ticks, n), -1, dtype=torch.int8)
            return soa._replace(now=soa.now + dt_ms * num_ticks), empty
        if fault == "half":
            # the second half of the rows is left out of the step
            keep = [t[n // 2:].clone() for t in (soa.features, soa.stage, soa.fire_at,
                                                 soa.active, soa.rematch)]
            soa, stages = real(params, soa, dt_ms, num_ticks)
            for t, k in zip((soa.features, soa.stage, soa.fire_at, soa.active, soa.rematch), keep):
                t[n // 2:] = k
            stages[:, n // 2:] = -1
            return soa, stages
        if fault == "altered":
            # a fired stage is reported as another stage where it is produced
            soa, stages = real(params, soa, dt_ms, num_ticks)
            S = params.w_static.shape[0]
            rows = torch.arange(n) % 3 == 0
            hit = (stages >= 0) & rows[None, :]
            return soa, torch.where(hit, (stages + 1) % S, stages)
        raise AssertionError(fault)

    monkeypatch.setattr(T, "_run_ticks_collect_impl", broken)


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
def test_fault_in_the_timed_path_is_not_correct(monkeypatch, fault):
    impl_patch(monkeypatch, fault)
    res = run_cell()
    assert not res.correct
    assert res.failed > 0


@pytest.mark.cuda
def test_on_the_card(card):
    """The sound program on the card at the test's size."""
    cell = spec.load_cell("chaos-10k.sim")
    res = spec.driver(cell).run(Ctx(cell, SEED, 0.5, False, device="cuda", scale=SCALE))
    assert res.correct
