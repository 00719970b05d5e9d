"""The scenarios of tests/test_device_backend.py through the port's
Controller facade (``kwok_tpu_torch.controllers.Controller``) with
``device="cpu"``, where its device players and lease lane run the
kernels' plain versions; and the facade's guards."""

import time

import pytest

from kwok_tpu_torch.api.config import KwokConfiguration
from kwok_tpu_torch.cluster.store import ResourceStore
from kwok_tpu_torch.controllers import Controller
from kwok_tpu_torch.stages import default_node_stages, default_pod_stages, load_builtin

from tests.test_controllers import make_node, make_pod, wait_for


@pytest.fixture
def device_cluster():
    store = ResourceStore()
    ctr = Controller(
        store,
        KwokConfiguration(
            manage_all_nodes=True,
            backend="device",
            device_tick_ms=20,
            node_lease_duration_seconds=40,
        ),
        local_stages={
            "Node": default_node_stages(lease=True),
            "Pod": default_pod_stages(),
        },
        seed=0,
        device="cpu",
    )
    ctr.start()
    yield store, ctr
    ctr.stop()


def test_device_backend_selected(device_cluster):
    store, ctr = device_cluster
    assert "Pod" in ctr.device_players, "pod stages should lower to the device"
    assert "Node" in ctr.device_players, "node stages should lower to the device"
    assert ctr.pods is None and ctr.nodes is None
    # lease renewals ride the node player's tick on the port's lane
    from kwok_tpu_torch.controllers.device_lease import DeviceLeaseLane

    assert isinstance(ctr.node_leases._lane, DeviceLeaseLane)
    assert ctr.device_players["Node"].post_tick == ctr.node_leases._lane.tick


def test_device_node_initialize(device_cluster):
    store, ctr = device_cluster
    store.create(make_node("node-0"))
    assert wait_for(
        lambda: any(
            c.get("type") == "Ready" and c.get("status") == "True"
            for c in (store.get("Node", "node-0").get("status") or {}).get("conditions", [])
        ),
        timeout=15.0,
    ), "node never became Ready on device backend"
    assert store.get("Node", "node-0")["status"]["phase"] == "Running"


def test_device_pod_lifecycle_parity(device_cluster):
    store, ctr = device_cluster
    store.create(make_node("node-0"))
    assert wait_for(lambda: ctr.manages("node-0"))
    for i in range(10):
        store.create(make_pod(f"p{i}"))
    assert wait_for(
        lambda: all(
            (store.get("Pod", f"p{i}").get("status") or {}).get("phase") == "Running"
            for i in range(10)
        ),
        timeout=15.0,
    ), "pods never Running on device backend"
    # status parity with the host backend's contract
    pod = store.get("Pod", "p0")
    assert pod["status"]["podIP"]
    assert pod["status"]["hostIP"]
    assert any(
        c.get("type") == "Ready" and c.get("status") == "True"
        for c in pod["status"].get("conditions", [])
    )
    # pod IPs unique
    ips = {store.get("Pod", f"p{i}")["status"]["podIP"] for i in range(10)}
    assert len(ips) == 10
    # graceful delete -> reaped by the pod-delete stage
    store.delete("Pod", "p0")
    assert wait_for(lambda: store.count("Pod") == 9, timeout=15.0), "pod never reaped"


def test_device_row_recycling(device_cluster):
    """Rows released by deletes are reused by later admits."""
    store, ctr = device_cluster
    store.create(make_node("node-0"))
    assert wait_for(lambda: ctr.manages("node-0"))
    for i in range(5):
        store.create(make_pod(f"a{i}"))
    assert wait_for(
        lambda: all(
            (store.get("Pod", f"a{i}").get("status") or {}).get("phase") == "Running"
            for i in range(5)
        ),
        timeout=15.0,
    )
    for i in range(5):
        store.delete("Pod", f"a{i}")
    assert wait_for(lambda: store.count("Pod") == 0, timeout=15.0)
    player = ctr.device_players["Pod"]
    assert wait_for(lambda: len(player.sim._free) > 0, timeout=5.0)
    hw = player.sim.num_rows
    for i in range(5):
        store.create(make_pod(f"b{i}"))
    assert wait_for(
        lambda: all(
            (store.get("Pod", f"b{i}").get("status") or {}).get("phase") == "Running"
            for i in range(5)
        ),
        timeout=15.0,
    )
    assert player.sim.num_rows <= hw + 1, "released rows were not recycled"


def test_device_chaos_stages_compile():
    """The chaos stage set (weighted failure paths) lowers to the device
    and produces CrashLoopBackOff-style churn."""
    store = ResourceStore()
    ctr = Controller(
        store,
        KwokConfiguration(
            manage_all_nodes=True,
            backend="device",
            device_tick_ms=20,
            node_lease_duration_seconds=0,
        ),
        local_stages={
            "Node": default_node_stages(),
            "Pod": load_builtin("pod-general") + load_builtin("pod-chaos"),
        },
        seed=3,
        device="cpu",
    )
    ctr.start()
    try:
        assert "Pod" in ctr.device_players
        store.create(make_node("node-0"))
        assert wait_for(lambda: ctr.manages("node-0"))
        pod = make_pod("crashy")
        pod["metadata"]["labels"] = {
            "pod-container-running-failed.stage.kwok.x-k8s.io": "true"
        }
        store.create(pod)
        assert wait_for(
            lambda: (store.get("Pod", "crashy").get("status") or {}).get("phase")
            is not None,
            timeout=15.0,
        )
    finally:
        ctr.stop()


def test_device_pod_on_node_managed_later_catches_up(device_cluster):
    """Pods created before their node is managed are replayed to the
    device player on lease acquisition (device analog of sync_node)."""
    store, ctr = device_cluster
    store.create(make_pod("early", node="node-9"))
    time.sleep(0.3)
    store.create(make_node("node-9"))
    assert wait_for(
        lambda: (store.get("Pod", "early").get("status") or {}).get("phase") == "Running",
        timeout=15.0,
    )


def test_device_cr_mode_recompiles_on_new_stages():
    """Stage CRs arriving after the first recompile the device player
    (AOT sets are immutable; the facade rebuilds on update)."""
    store = ResourceStore()
    ctr = Controller(
        store,
        KwokConfiguration(
            manage_all_nodes=True,
            backend="device",
            device_tick_ms=20,
            node_lease_duration_seconds=0,
        ),
        local_stages=None,
        seed=0,
        device="cpu",
    )
    ctr.start()
    try:
        all_stages = default_pod_stages()
        # deliver only pod-ready first
        store.create(next(s for s in all_stages if s.name == "pod-ready").to_dict())
        for s in default_node_stages():
            store.create(s.to_dict())
        store.create(make_node("node-0"))
        assert wait_for(lambda: ctr.manages("node-0"))
        store.create(make_pod("p0"))
        assert wait_for(
            lambda: (store.get("Pod", "p0").get("status") or {}).get("phase") == "Running",
            timeout=15.0,
        )
        # now deliver pod-delete; a graceful delete must be honored
        for s in all_stages:
            if s.name != "pod-ready":
                store.create(s.to_dict())
        store.delete("Pod", "p0")
        assert wait_for(lambda: store.count("Pod") == 0, timeout=15.0), (
            "recompiled device player never reaped the pod"
        )
    finally:
        ctr.stop()


def test_host_fallback_for_unlowerable_stages():
    """A stage set using arbitrary templates the AOT compiler cannot
    lower falls back to the host backend transparently."""
    from kwok_tpu_torch.api.loader import load_stages

    stages = load_stages(
        """
apiVersion: kwok.x-k8s.io/v1alpha1
kind: Stage
metadata:
  name: odd-stage
spec:
  resourceRef:
    apiGroup: v1
    kind: Pod
  selector:
    matchExpressions:
      - key: .status.phase
        operator: DoesNotExist
  next:
    statusTemplate: |
      phase: {{ if .metadata.labels.special }}Special{{ else }}Running{{ end }}
      oddField: {{ .metadata.name }}-{{ .spec.nodeName }}
"""
    )
    store = ResourceStore()
    ctr = Controller(
        store,
        KwokConfiguration(
            manage_all_nodes=True,
            backend="device",
            node_lease_duration_seconds=0,
        ),
        local_stages={"Node": default_node_stages(), "Pod": stages},
        seed=0,
        device="cpu",
    )
    ctr.start()
    try:
        store.create(make_node("node-0"))
        assert wait_for(lambda: ctr.manages("node-0"))
        store.create(make_pod("p0"))
        assert wait_for(
            lambda: (store.get("Pod", "p0").get("status") or {}).get("phase") == "Running"
        )
        assert store.get("Pod", "p0")["status"]["oddField"] == "p0-node-0"
    finally:
        ctr.stop()


def test_exotic_stage_demotes_kind_to_host():
    """The compile-subset seam is per KIND, not per stage: one
    non-lowerable stage (json-patch type) in the Pod set routes ALL pod
    simulation to the host backend, while Node stays on device
    (engine/compiler.py docstring pins the rationale)."""
    from kwok_tpu_torch.api.types import Stage

    exotic = Stage.from_dict(
        {
            "metadata": {"name": "exotic-json-patch"},
            "spec": {
                "resourceRef": {"kind": "Pod"},
                "selector": {
                    "matchExpressions": [
                        {"key": ".metadata.annotations.exotic", "operator": "Exists"}
                    ]
                },
                "next": {"patches": [{"type": "json", "template": "[]"}]},
            },
        }
    )
    store = ResourceStore()
    ctr = Controller(
        store,
        KwokConfiguration(
            manage_all_nodes=True,
            backend="device",
            node_lease_duration_seconds=0,
        ),
        local_stages={
            "Node": default_node_stages(),
            "Pod": default_pod_stages() + [exotic],
        },
        seed=0,
        device="cpu",
    )
    ctr.start()
    try:
        assert "Pod" not in ctr.device_players, "exotic set must not lower"
        assert ctr.pods is not None, "host PodController must take over"
        assert "Node" in ctr.device_players, "Node set unaffected"
        # the demoted kind still simulates correctly on the host path
        store.create(make_node("node-0"))
        assert wait_for(lambda: ctr.manages("node-0"))
        store.create(make_pod("p0"))
        assert wait_for(
            lambda: (store.get("Pod", "p0").get("status") or {}).get("phase")
            == "Running",
            timeout=15.0,
        )
    finally:
        ctr.stop()


def test_custom_cr_kind_on_device_backend():
    """Generic kinds (the StageController seat) also lower to the
    device path: a Widget stage set compiles, the kind gets a device
    player, and status converges through the batched drain."""
    from kwok_tpu_torch.api.loader import load_stages
    from kwok_tpu_torch.cluster.store import ResourceType

    store = ResourceStore()
    store.register_type(ResourceType("example.com/v1", "Widget", "widgets"))
    stages = load_stages(
        """
apiVersion: kwok.x-k8s.io/v1alpha1
kind: Stage
metadata:
  name: widget-ready
spec:
  resourceRef:
    apiGroup: example.com/v1
    kind: Widget
  selector:
    matchExpressions:
      - key: .status.phase
        operator: DoesNotExist
  next:
    statusTemplate: |
      phase: Ready
"""
    )
    ctr = Controller(
        store,
        KwokConfiguration(
            manage_all_nodes=True,
            backend="device",
            device_tick_ms=20,
            node_lease_duration_seconds=0,
        ),
        local_stages={"Widget": stages},
        seed=0,
        device="cpu",
    )
    ctr.start()
    try:
        assert "Widget" in ctr.device_players, "widget stages should lower"
        for i in range(5):
            store.create(
                {
                    "apiVersion": "example.com/v1",
                    "kind": "Widget",
                    "metadata": {"name": f"w{i}"},
                }
            )
        assert wait_for(
            lambda: all(
                (store.get("Widget", f"w{i}").get("status") or {}).get("phase")
                == "Ready"
                for i in range(5)
            ),
            timeout=15.0,
        )
    finally:
        ctr.stop()


def test_fast_drain_notices_interleaved_external_write():
    """An external write (label removal) committed to the store but not
    yet drained when the row's next transition fires must be adopted
    WITH a feature re-extraction: the fast drain's commit echo carries
    it, and its own watch event is then rv-suppressed, so the echo
    adoption guard (confirm_row -> refresh_row) is the only place it
    can take effect (code-review r03 finding #1)."""
    from kwok_tpu_torch.cluster.informer import WatchOptions
    from kwok_tpu_torch.controllers.device_player import DeviceStagePlayer
    from kwok_tpu_torch.controllers.pod_controller import PodEnv

    store = ResourceStore()
    stages = load_builtin("pod-general") + load_builtin("pod-chaos")
    env = PodEnv()
    player = DeviceStagePlayer(
        store, "Pod", stages, capacity=8, tick_ms=100,
        funcs_for=env.funcs, on_delete=env.release, seed=3, device="cpu",
    )
    pod = make_pod("p0")
    pod["metadata"]["labels"] = {
        "pod-container-running-failed.stage.kwok.x-k8s.io": "true"
    }
    store.create(pod)
    player.cache = player._informer.watch_with_cache(
        WatchOptions(), player.events, done=player._done
    )
    time.sleep(0.3)
    player._drain_events()
    # let the chaos<->ready cycle establish itself
    for _ in range(6):
        player._drain_events()
        player.step_batch(100, 10)
    assert player.transitions >= 2

    # external writer removes the chaos opt-in label; do NOT drain —
    # the next fired transition's commit echo must carry it
    store.patch(
        "Pod", "p0",
        {"metadata": {"labels": {
            "pod-container-running-failed.stage.kwok.x-k8s.io": None}}},
        "merge", namespace="default",
    )
    for _ in range(4):
        player.step_batch(100, 10)
        player._drain_events()
    # chaos must stop matching: transitions settle (at most a final
    # pod-ready) and the pod ends Running
    settled = player.transitions
    for _ in range(6):
        player._drain_events()
        player.step_batch(100, 10)
    assert player.transitions - settled <= 1, (
        "row kept cycling on stale features after external label removal"
    )
    assert store.get("Pod", "p0", namespace="default")["status"]["phase"] == "Running"
    player._done.set()


def test_mesh_is_refused_until_ported():
    """device_mesh_devices asks for that many distinct cards, and is
    refused where there are fewer; with device="cpu" it takes that many
    CPU shards."""
    import torch

    if torch.cuda.device_count() < 2:
        with pytest.raises(ValueError, match="mesh wants 2 devices"):
            Controller(
                ResourceStore(),
                KwokConfiguration(backend="device", device_mesh_devices=2),
                device="cuda",
            )
    ctr = Controller(
        ResourceStore(),
        KwokConfiguration(backend="device", device_mesh_devices=2),
        device="cpu",
    )
    assert ctr._device_mesh.size == 2
    assert {str(d) for d in ctr._device_mesh.devices} == {"cpu"}


def test_host_backend_needs_no_device():
    ctr = Controller(ResourceStore(), KwokConfiguration(manage_all_nodes=True))
    assert ctr.device is None
