"""Share of the run's ``tick_many`` fetches whose fired stages the row
kernel wrote into pinned host memory itself, in % (the ``_count`` of
``kwok_sim_fetch_bytes{kind,memory}`` under ``mapped`` over all of them,
pods and nodes).  A program without the histogram, or with no fetch
observed, reads ``None``; one whose fetches copy reads 0."""

from kwokbench import promtext, simphase

COUNT = "kwok_sim_fetch_bytes_count"


def read(data):
    memory = {}
    for name, labels, value in promtext.iter_samples(simphase.exposition()):
        if name == COUNT:
            memory[labels.get("memory")] = memory.get(labels.get("memory"), 0.0) + value
    total = sum(memory.values())
    return 100.0 * memory.get("mapped", 0.0) / total if total else None
