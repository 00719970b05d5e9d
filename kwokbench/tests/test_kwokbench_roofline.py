"""The copied least-time arithmetic equals the original's."""

import importlib.util
import os
from collections import namedtuple

import pytest
import torch

from kwokbench import roofline, spec

Params = namedtuple("Params", "cond_col eff_mode")


def smoke():
    path = os.path.join(spec.ROOT, "chip_smoke.py")
    if not os.path.exists(path):
        pytest.skip("chip_smoke.py, the original, is gone")
    s = importlib.util.spec_from_file_location("chip_smoke_original", path)
    m = importlib.util.module_from_spec(s)
    s.loader.exec_module(m)
    return m


@pytest.mark.parametrize("S,KC,C,n,ticks,rematches", [
    (9, 4, 13, 1_000_000, 8, 391_000), (2, 2, 2, 10_000, 8, 0),
    (128, 7, 17, 1_000_003, 1, 1_000_003), (9, 4, 13, 1_000_000, 600, 10**8)])
def test_tick_bound_equals_chip_smoke(S, KC, C, n, ticks, rematches):
    m = smoke()
    params = Params(torch.zeros((S, KC), dtype=torch.int32),
                    torch.zeros((3, S, C), dtype=torch.int32))
    pbytes = m.param_bytes(params)
    want_ms, want_kind = m.tick_bound(params, n, ticks, rematches, ticks * n)
    got_s, got_kind = roofline.tick_bound(S, KC, C, pbytes, n, ticks, rematches, ticks * n)
    assert got_kind == want_kind
    assert got_s * 1e3 == pytest.approx(want_ms, rel=1e-12)
    assert roofline.row_bytes(C) == m.row_bytes(C)
    assert (roofline.HBM_BYTES_PER_S, roofline.INT32_OPS_PER_S) == (
        m.HBM_BYTES_PER_S, m.INT32_OPS_PER_S)
