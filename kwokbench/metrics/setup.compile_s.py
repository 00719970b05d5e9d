"""Seconds of set-up spent compiling the stage sets
(``kwok_sim_phase_seconds{phase="compile"}``, every simulator of the
run)."""

from kwokbench import simphase


def read(data):
    return simphase.seconds(simphase.exposition(), "compile")
