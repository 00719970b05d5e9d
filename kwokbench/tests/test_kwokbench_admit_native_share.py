"""``setup.admit_native_share``: the share of the admission keys the
program built in its native pass, from ``kwok_sim_admit_keys_total``; a
program without the counter (one that builds every key in Python, as
before the counter) reads ``None``, and the result line leaves it out."""

import pytest

from kwokbench import simphase, spec

NAME = "setup.admit_native_share"
PHASES_ONLY = """\
# TYPE kwok_sim_phase_seconds histogram
kwok_sim_phase_seconds_sum{kind="Pod",phase="admit"} 41.5
kwok_sim_phase_seconds_count{kind="Pod",phase="admit"} 1000000
# TYPE kwok_sim_signatures gauge
kwok_sim_signatures{kind="Pod"} 4
"""
WITH = PHASES_ONLY + """\
# TYPE kwok_sim_admit_keys_total counter
kwok_sim_admit_keys_total{kind="Node",path="native"} 10000
kwok_sim_admit_keys_total{kind="Pod",path="native"} 999990
kwok_sim_admit_keys_total{kind="Pod",path="plain"} 10
"""


@pytest.mark.parametrize("text", [PHASES_ONLY, ""])
def test_reads_none_without_the_counter(monkeypatch, text):
    monkeypatch.setattr(simphase, "exposition", lambda: text)
    assert spec.load_reader(spec.HERE, NAME)({}) is None


def test_reads_the_native_share(monkeypatch):
    monkeypatch.setattr(simphase, "exposition", lambda: WITH)
    assert spec.load_reader(spec.HERE, NAME)({}) == pytest.approx(100.0 * 1_009_990 / 1_010_000)
