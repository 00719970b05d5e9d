"""kwok_tpu_torch.graft_entry: the port's counterparts of
``__graft_entry__.entry`` and ``dryrun_multichip``, on the CPU.

``entry`` ticks the 64-row flagship FSM exactly as the JAX entry does;
``dryrun_multichip`` runs the sharded tick, the multi-tick loop and the
full player drain with GC over CPU shards, and raises on any
divergence from the unsharded run.  The reference's 65,536-row dry run
takes most of a minute on one CPU core, so it is ``slow``; the small
one runs every time.
"""

import numpy as np
import pytest

import __graft_entry__ as jax_entry
from kwok_tpu_torch import graft_entry


def test_entry_ticks_like_the_jax_entry():
    fn, (params, soa) = graft_entry.entry(device="cpu")
    jfn, (jparams, jsoa) = jax_entry.entry()
    assert soa.features.shape[0] == 64
    for _ in range(30):
        soa, out = fn(params, soa)
        jsoa, jout = jfn(jparams, jsoa)
        assert int(out.fired_count) == int(jout.fired_count)
        assert np.array_equal(out.fired_stage.numpy(), np.asarray(jout.fired_stage))
    assert np.array_equal(soa.stage.numpy(), np.asarray(jsoa.stage))
    assert int(soa.now) == int(jsoa.now) == 3000


@pytest.mark.parametrize("shards,rows", [(8, 512), (3, 1000)])
def test_dryrun_multichip_small(shards, rows, capsys):
    graft_entry.dryrun_multichip(shards, devices=["cpu"] * shards, n_rows=rows)
    out = capsys.readouterr().out
    assert f"{shards} shards" in out and "parity OK" in out and "gc reaped 1 orphans" in out


@pytest.mark.slow
def test_dryrun_multichip_reference_size(capsys):
    graft_entry.dryrun_multichip(8, devices=["cpu"] * 8)
    assert "65536 rows" in capsys.readouterr().out
