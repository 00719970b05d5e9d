"""The mixes draw the same work from the same seed."""

import numpy as np

from kwokbench import spec
from kwokbench.drivers import kwokctl_stream as stream
from kwokbench.reference import control, threefry


def test_arrivals_repeat_for_a_seed_and_keep_their_count():
    a = stream.arrivals(2**33 + 5, 400, 30.0)
    b = stream.arrivals(2**33 + 5, 400, 30.0)
    c = stream.arrivals(2**33 + 6, 400, 30.0)
    assert np.array_equal(a, b)
    assert len(c) == len(a) and not np.array_equal(a, c)
    assert np.all(np.diff(a) >= 0) and a[0] >= 0 and a[-1] < 30.0


def test_simulator_draws_repeat_for_a_seed():
    rows = np.array([0, 7, 999_999])
    a = control.draws(3_000_000_123, rows, 50)
    b = control.draws(3_000_000_123, rows, 50)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert a[0].dtype == np.float32 and a[0].shape == (50, 3)
    assert np.all((a[0] >= 0) & (a[0] < 1))


def test_threefry_known_answer():
    # the Random123 known-answer vector of threefry2x32 with 20 rounds
    assert threefry.threefry_int(0, 0, 0, 0) == (0x6B200159, 0x99BA4EFE)
    x0, x1 = threefry.threefry_np(np.uint32(0xFFFFFFFF), np.uint32(0xFFFFFFFF),
                                  np.array([0xFFFFFFFF], np.uint32),
                                  np.array([0xFFFFFFFF], np.uint32))
    assert (int(x0[0]), int(x1[0])) == (0x1CB996FC, 0xBB002BE7)


def test_every_mix_names_a_driver_that_exists():
    import importlib
    import json
    import os

    for name in os.listdir(os.path.join(spec.HERE, "traffic")):
        with open(os.path.join(spec.HERE, "traffic", name)) as f:
            importlib.import_module(f"kwokbench.drivers.{json.load(f)['driver']}")
