"""Share of the run's admission keys that the program built in its native
pass, in % (``kwok_sim_admit_keys_total{kind,path}``: native over native
and plain, pods and nodes).  A program without the counter reads
``None``."""

from kwokbench import promtext, simphase

COUNTER = "kwok_sim_admit_keys_total"


def read(data):
    paths = {}
    for name, labels, value in promtext.iter_samples(simphase.exposition()):
        if name == COUNTER:
            paths[labels.get("path")] = paths.get(labels.get("path"), 0.0) + value
    total = sum(paths.values())
    return 100.0 * paths.get("native", 0.0) / total if total else None
