"""Launch time per pod+node macro-tick (ms), as the program observes it
(``kwok_sim_phase_seconds{phase="launch"}``: the tick kernels' argument
checks, output allocation and launch in ``tick_many``).  The mean over
every macro-tick of the run: the warm-up, the traced first seconds and
the untraced rest of the window."""

from kwokbench import simphase


def read(data):
    return simphase.ms_per_call(simphase.exposition(), "launch")
