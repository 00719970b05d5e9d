"""``simulator.fetch_mapped_share``: the share of the ``tick_many``
fetches whose bytes the row kernel wrote into pinned host memory, from
the ``_count`` of ``kwok_sim_fetch_bytes``; a program without the
histogram reads ``None``, and the result line leaves it out."""

import pytest

from kwokbench import simphase, spec

NAME = "simulator.fetch_mapped_share"
PHASES_ONLY = """\
# TYPE kwok_sim_phase_seconds histogram
kwok_sim_phase_seconds_sum{kind="Pod",phase="fetch"} 1.5
kwok_sim_phase_seconds_count{kind="Pod",phase="fetch"} 6000
"""


def fetched(**counts):
    lines = ["# TYPE kwok_sim_fetch_bytes histogram"]
    for key, n in counts.items():
        kind, memory = key.split("_")
        lines += [
            f'kwok_sim_fetch_bytes_bucket{{kind="{kind}",memory="{memory}",le="1e+07"}} {n}',
            f'kwok_sim_fetch_bytes_sum{{kind="{kind}",memory="{memory}"}} {n * 8e6}',
            f'kwok_sim_fetch_bytes_count{{kind="{kind}",memory="{memory}"}} {n}',
        ]
    return PHASES_ONLY + "\n".join(lines) + "\n"


@pytest.mark.parametrize("text, share", [
    (fetched(Pod_mapped=6000, Node_mapped=6000), 100.0),
    (fetched(Pod_pinned=6000, Node_pinned=6000), 0.0),
    (fetched(Pod_mapped=3000, Pod_pinned=1000), 75.0),
    (PHASES_ONLY, None),
    ("", None),
], ids=["mapped", "copied", "mixed", "phases-only", "empty"])
def test_reads_the_mapped_share(monkeypatch, text, share):
    monkeypatch.setattr(simphase, "exposition", lambda: text)
    got = spec.load_reader(spec.HERE, NAME)({})
    assert got == (None if share is None else pytest.approx(share))
