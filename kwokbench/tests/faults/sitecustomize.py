"""Plants a fault in the kwok daemon's timed path, for the stream
cell's tests on the CPU.

``test_kwokbench_stream_cell.py`` puts this directory on the
``PYTHONPATH`` of the cluster it starts, with ``KWOKBENCH_TEST_FAULT``
naming the fault and ``KWOKBENCH_TEST_FAULT_ARM`` a file that the test
creates when the window opens.  In the ``kwok-controller`` process the
plain multi-tick step (``ops.tick._run_ticks_collect_impl``, the CPU
path of ``run_ticks_collect``) is wrapped; while the file exists, steps
of the pod stage set (more than two stages; the node set has two) are
broken:

- ``unchanged``: the step returns its state unchanged and fires nothing;
- ``half``: every other row is left out of the step;
- ``altered``: each fired stage is reported as the next stage.
"""

import os


def _arm() -> None:
    fault = os.environ.get("KWOKBENCH_TEST_FAULT")
    arm = os.environ.get("KWOKBENCH_TEST_FAULT_ARM")
    if not fault or not arm or os.environ.get("KWOK_COMPONENT_NAME") != "kwok-controller":
        return
    import torch

    from kwok_tpu_torch.ops import tick

    real = tick._run_ticks_collect_impl

    def broken(params, soa, dt_ms, num_ticks):
        S = params.w_static.shape[0]
        if S <= 2 or not os.path.exists(arm):
            return real(params, soa, dt_ms, num_ticks)
        n = soa.features.shape[0]
        if fault == "unchanged":
            return (soa._replace(now=soa.now + dt_ms * num_ticks),
                    torch.full((num_ticks, n), -1, dtype=torch.int8))
        cols = (soa.features, soa.stage, soa.fire_at, soa.active, soa.rematch)
        if fault == "half":
            keep = [t[1::2].clone() for t in cols]
            soa, stages = real(params, soa, dt_ms, num_ticks)
            for t, k in zip((soa.features, soa.stage, soa.fire_at, soa.active, soa.rematch), keep):
                t[1::2] = k
            stages[:, 1::2] = -1
            return soa, stages
        soa, stages = real(params, soa, dt_ms, num_ticks)
        return soa, torch.where(stages >= 0, (stages + 1) % S, stages)

    tick._run_ticks_collect_impl = broken


_arm()
