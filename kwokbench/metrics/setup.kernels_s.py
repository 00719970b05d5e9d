"""Seconds of set-up spent loading the CUDA kernels, their nvcc build
included when the build cache misses
(``kwok_sim_phase_seconds{phase="kernels"}``, every simulator of the
run)."""

from kwokbench import simphase


def read(data):
    return simphase.seconds(simphase.exposition(), "kernels")
