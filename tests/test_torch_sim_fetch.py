"""The fetch of the port's DeviceSimulator: tick_many's, and the
player's overlapped hand-off (``start_fetch``).

The int8 macro-tick's fired stages come to the host once the kernel has
run: on the card the row kernel writes them into a pinned host block of
the launch's own (``mapped``), on the CPU they are the plain version's
output.  Either way the array is the caller's: a later call never writes
into it, and it equals ``run_ticks_collect``'s output fetched by hand,
bit for bit; batches in flight through ``step_pipelined`` come back as
``step_batch``'s.  ``kwok_sim_fetch_bytes{kind,memory}`` counts each
``tick_many`` call's bytes by the memory they land in.  The tests marked
``cuda`` skip without a card (``python -m pytest --noconftest -q
tests/test_torch_sim_fetch.py`` on it).
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from kwok_tpu_torch.engine import simulator as simmod
from kwok_tpu_torch.engine.simulator import DeviceSimulator
from kwok_tpu_torch.ops.tick import load_kernels, run_ticks_collect
from kwok_tpu_torch.stages import default_node_stages, load_builtin
from kwok_tpu_torch.utils import telemetry

CHAOS = {"pod-container-running-failed.stage.kwok.x-k8s.io": "true"}
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def pod(i=0, labels=None):
    meta = {"name": f"p{i}", "namespace": "d", "uid": f"u{i}"}
    if labels:
        meta["labels"] = labels
    return {
        "apiVersion": "v1",
        "kind": "Pod",
        "metadata": meta,
        "spec": {"nodeName": "n0", "containers": [{"name": "c", "image": "img"}]},
        "status": {},
    }


def pod_sim(device, seed=0, rows=200, capacity=256):
    stages = load_builtin("pod-general") + load_builtin("pod-chaos")
    sim = DeviceSimulator(stages, capacity=capacity, seed=seed, device=device)
    sim.admit_bulk(pod(labels=CHAOS), rows)
    return sim


@pytest.fixture(autouse=True)
def fresh_family():
    """An empty fetch family, telemetry armed, for each test (the family
    is process-global; it is cleared in place, never replaced)."""
    prev = telemetry.set_enabled(True)
    simmod._H_FETCH.clear()
    yield
    simmod._H_FETCH.clear()
    telemetry.set_enabled(prev)


def fetches():
    """{(kind, memory): (observations, bytes)}."""
    return {lv: (c["count"], c["sum"]) for lv, c in simmod._H_FETCH.snapshot().items()}


def by_hand(device, seed, calls, K=8, dt=250):
    """``run_ticks_collect`` on a twin simulator's device state, each
    output fetched with a plain ``.cpu()`` and copied (on the card the
    launch also writes a pinned block, which this leaves unread)."""
    twin = pod_sim(device, seed)
    params, soa = twin.to_device()
    out = []
    for _ in range(calls):
        if soa.features.is_cuda:
            host = torch.empty((K, soa.features.shape[0]), dtype=torch.int8, pin_memory=True)
            soa, stages = run_ticks_collect(params, soa, dt, K, host=host)
        else:
            soa, stages = run_ticks_collect(params, soa, dt, K)
        out.append(stages.cpu().numpy().copy())
    return out


def check_bit_identical(device, seed):
    sim = pod_sim(device, seed)
    got = [sim.tick_many(250, 8)[0] for _ in range(6)]
    want = by_hand(device, seed, 6)
    assert sum(int((w >= 0).sum()) for w in want) > 0
    for g, w in zip(got, want):
        assert g.dtype == np.int8 and g.shape == w.shape == (8, 256)
        assert np.array_equal(g, w)


def check_arrays_are_the_callers(device):
    sim = pod_sim(device)
    first, _ = sim.tick_many(250, 8)
    kept = first.copy()
    second, _ = sim.tick_many(250, 8)
    assert not np.shares_memory(first, second)
    assert np.array_equal(first, kept)
    # a third call, with the second dropped, writes into neither survivor
    del second
    third, _ = sim.tick_many(250, 8)
    assert not np.shares_memory(first, third)
    assert np.array_equal(first, kept)
    return first, third


def recording_player(device, seed=5):
    """A player on ``pod_sim``'s objects whose drain only keeps the
    fired-stage arrays it is handed, so nothing the host does reaches the
    device and a pipelined player ticks as a stepped one does."""
    from kwok_tpu_torch.cluster.store import ResourceStore
    from kwok_tpu_torch.controllers.device_player import DeviceStagePlayer

    stages = load_builtin("pod-general") + load_builtin("pod-chaos")
    player = DeviceStagePlayer(ResourceStore(), "Pod", stages, capacity=256, seed=seed,
                               device=device)
    player.sim.admit_bulk(pod(labels=CHAOS), 200)
    batches = []
    player._drain_stages = lambda stages_np, t0_ms, dt: batches.append(stages_np) or 0
    return player, batches


def check_pipelined_batches_are_the_callers(device):
    """Batches in flight through step_pipelined come back as arrays of
    their own, equal to step_batch's on the same seed."""
    piped, got = recording_player(device)
    for _ in range(3):
        piped.step_pipelined(250, 8)
    assert len(got) == 2 and piped._inflight is not None
    piped.flush_pipeline()
    stepped, want = recording_player(device)
    for _ in range(3):
        stepped.step_batch(250, 8)
    assert len(got) == len(want) == 3
    assert sum(int((w >= 0).sum()) for w in want) > 0
    for i, g in enumerate(got):
        assert not any(np.shares_memory(g, h) for h in got[i + 1:])
        assert g.dtype == np.int8 and np.array_equal(g, want[i])
    return got


@pytest.mark.parametrize("seed", [0, 7, 3_000_000_019])
def test_fired_stages_equal_run_ticks_collect_fetched_by_hand(seed):
    check_bit_identical("cpu", seed)


def test_successive_calls_return_arrays_of_their_own():
    check_arrays_are_the_callers("cpu")


def test_pipelined_batches_are_arrays_of_their_own():
    check_pipelined_batches_are_the_callers("cpu")


def test_host_fetch_counts_one_observation_a_call_with_k_times_n_bytes():
    sim = pod_sim("cpu")
    node = DeviceSimulator(default_node_stages(lease=True), capacity=40, device="cpu")
    for k in (8, 8, 3):
        sim.tick_many(100, k)
    node.tick_many(100, 8)
    assert fetches() == {("Pod", "host"): (3, 256 * 19), ("Node", "host"): (1, 40 * 8)}


def test_nothing_is_counted_under_kwok_telemetry_0():
    """The environment variable, read when the process starts."""
    code = textwrap.dedent("""
        import sys
        sys.path.insert(0, sys.argv[1])
        from kwok_tpu_torch.engine import simulator as simmod
        from kwok_tpu_torch.engine.simulator import DeviceSimulator
        from kwok_tpu_torch.stages import default_node_stages
        sim = DeviceSimulator(default_node_stages(lease=True), capacity=16, device="cpu")
        for _ in range(3):
            sim.tick_many(100, 8)
        print(len(simmod._H_FETCH.snapshot()), len(simmod._H_PHASE.snapshot()))
    """)
    env = dict(os.environ, KWOK_TELEMETRY="0")
    out = subprocess.run([sys.executable, "-c", code, ROOT], env=env, capture_output=True,
                         text=True, timeout=120, check=True)
    assert out.stdout.split() == ["0", "0"]


@pytest.mark.parametrize("bad, error", [
    (torch.empty((8, 40), dtype=torch.int32), TypeError),
    (torch.empty((8, 41), dtype=torch.int8), ValueError),
    (torch.empty((40, 8), dtype=torch.int8).t(), ValueError),
    (torch.empty((8, 40), dtype=torch.int8, device="meta"), ValueError),
], ids=["int32", "shape", "strided", "off-host"])
def test_host_block_must_be_an_int8_k_by_n_host_block(bad, error):
    from kwok_tpu_torch.ops import kernels

    with pytest.raises(error):
        kernels.check_host_block(bad, (8, 40))


def test_the_plain_collect_refuses_a_host_block():
    params, soa = pod_sim("cpu").to_device()
    with pytest.raises(ValueError, match="card"):
        run_ticks_collect(params, soa, 100, 8, host=torch.empty((8, 256), dtype=torch.int8))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the pinned fetch runs on the card only")
    load_kernels(torch.device("cuda"))
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [0, 3_000_000_019])
def test_card_fired_stages_equal_run_ticks_collect_fetched_by_hand(cuda_device, seed):
    check_bit_identical(cuda_device, seed)


@pytest.mark.cuda
def test_card_arrays_are_the_callers_and_pinned(cuda_device, monkeypatch):
    def no_device_sync(*a, **k):
        raise AssertionError("the fetch waits on its own copy, not the whole device")

    monkeypatch.setattr(torch.cuda, "synchronize", no_device_sync)
    arrays = check_arrays_are_the_callers(cuda_device)
    for a in arrays:
        assert isinstance(a.base, torch.Tensor) and a.base.is_pinned()
    assert fetches() == {("Pod", "mapped"): (3, 3 * 8 * 256)}


@pytest.mark.cuda
def test_card_pinned_count_grows_by_one_a_call(cuda_device):
    sim = pod_sim(cuda_device)
    node = DeviceSimulator(default_node_stages(lease=True), capacity=40, device=cuda_device)
    for i in range(1, 5):
        sim.tick_many(100, 8)
        node.tick_many(100, 8)
        assert fetches() == {("Pod", "mapped"): (i, i * 8 * 256),
                             ("Node", "mapped"): (i, i * 8 * 40)}


@pytest.mark.cuda
def test_card_pipelined_batches_are_pinned_and_of_their_own(cuda_device, monkeypatch):
    def no_device_sync(*a, **k):
        raise AssertionError("the hand-off waits on its own copy, not the whole device")

    monkeypatch.setattr(torch.cuda, "synchronize", no_device_sync)
    for a in check_pipelined_batches_are_the_callers(cuda_device):
        assert isinstance(a.base, torch.Tensor) and a.base.is_pinned()


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 3])
@pytest.mark.parametrize("n", [1, 127, 128, 129, 1000])
@pytest.mark.parametrize("k", [1, 3, 8, 13])
def test_card_host_block_equals_device_output_and_plain(cuda_device, k, n, offset):
    """The kernel's host block holds its device output's bytes and the
    plain version's, at every edge of a 128-row line and at a block that
    starts off a word boundary (``offset``)."""
    params, soa = pod_sim(cuda_device, seed=n, rows=n, capacity=n).to_device()
    cparams, csoa = pod_sim("cpu", seed=n, rows=n, capacity=n).to_device()
    fired = 0
    for _ in range(8):
        host = torch.empty(offset + k * n, dtype=torch.int8, pin_memory=True)[offset:].view(k, n)
        host.fill_(-7)
        soa, stages = run_ticks_collect(params, soa, 1000, k, host=host)
        csoa, want = run_ticks_collect(cparams, csoa, 1000, k)
        torch.cuda.synchronize()
        assert torch.equal(stages.cpu(), want)
        assert torch.equal(host, want)
        fired += int((want >= 0).sum())
    assert fired > 0


@pytest.mark.cuda
def test_card_each_call_writes_a_block_of_its_own(cuda_device):
    """Every launch's kernel writes a fresh pinned block, and tick_many
    hands back that block, no copy of it."""
    sim = pod_sim(cuda_device)
    kept, blocks = [], set()
    for _ in range(4):
        stages, _ = sim.tick_many_async(250, 8)
        fetch = sim.start_fetch(stages)
        got = fetch.wait()
        assert fetch.memory == "mapped" and got.base.data_ptr() not in blocks
        assert np.array_equal(got, stages.cpu().numpy())
        blocks.add(got.base.data_ptr())
        kept.append(got)
    array, _ = sim.tick_many(250, 8)
    assert array.base.data_ptr() not in blocks and sim._newest is None


@pytest.mark.cuda
def test_card_block_is_not_reused_before_its_kernel_ends(cuda_device):
    """A block whose caller dropped it stays out of torch's host allocator
    until its kernel has run: a kernel's writes, unlike a copy's, leave
    no event with the allocator.  3,000 rows: blocks of 24,000 bytes, a
    size class of the allocator that no other test here uses."""
    sim = pod_sim(cuda_device, rows=3000, capacity=3000)
    sim.tick_many(250, 8)
    torch.cuda._sleep(200_000_000)  # ~0.1 s: the next kernels wait behind it
    first, _ = sim.tick_many_async(250, 8)
    block = sim._newest[1]._host.data_ptr()
    del first
    sim.tick_many_async(250, 8)  # takes the newest place; the first is dropped
    assert not sim._writing[0].written() and sim._writing[0]._host.data_ptr() == block
    fresh = [torch.empty((8, 3000), dtype=torch.int8, pin_memory=True) for _ in range(4)]
    assert block not in {t.data_ptr() for t in fresh}
    torch.cuda.synchronize()
    del fresh
    sim.tick_many(250, 8)
    assert len(sim._writing) == 1
    # once its kernel has run, the dropped block goes back to the allocator,
    # which hands it to the newest launch or to one of these
    again = [torch.empty((8, 3000), dtype=torch.int8, pin_memory=True) for _ in range(16)]
    assert block in {t.data_ptr() for t in again} | {f._host.data_ptr() for f in sim._writing}


@pytest.mark.cuda
def test_card_start_fetch_takes_the_newest_launch_once(cuda_device):
    sim = pod_sim(cuda_device)
    older, _ = sim.tick_many_async(250, 8)
    newest, _ = sim.tick_many_async(250, 8)
    with pytest.raises(ValueError, match="newest"):
        sim.start_fetch(older)
    fetch = sim.start_fetch(newest)
    with pytest.raises(ValueError, match="once"):
        sim.start_fetch(newest)
    assert np.array_equal(fetch.wait(), newest.cpu().numpy())


@pytest.mark.cuda
def test_card_collect_needs_a_host_block(cuda_device):
    params, soa = pod_sim(cuda_device).to_device()
    with pytest.raises(ValueError, match="pass host"):
        run_ticks_collect(params, soa, 100, 8)


@pytest.mark.cuda
def test_card_collect_refuses_a_pageable_host_block(cuda_device):
    params, soa = pod_sim(cuda_device).to_device()
    with pytest.raises(ValueError, match="pinned"):
        run_ticks_collect(params, soa, 100, 8, host=torch.empty((8, 256), dtype=torch.int8))
