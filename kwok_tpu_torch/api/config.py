"""KwokConfiguration options (config.kwok.x-k8s.io/v1alpha1 subset).

Mirrors the reference's controller-facing options and defaults
(reference: pkg/apis/config/v1alpha1/kwok_configuration_types.go and
zz_generated.defaults.go:61-102 — PodPlayStageParallelism=4,
NodePlayStageParallelism=4, NodeLeaseParallelism=4,
NodeLeaseDurationSeconds=40).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional


@dataclass
class KwokConfiguration:
    #: controller identity, used as the Lease holder
    #: (reference: controller.go HolderIdentity)
    id: str = "kwok-controller"
    manage_all_nodes: bool = False
    manage_nodes_with_annotation_selector: str = ""
    manage_nodes_with_label_selector: str = ""
    disregard_status_with_annotation_selector: str = ""
    disregard_status_with_label_selector: str = ""
    node_play_stage_parallelism: int = 4
    pod_play_stage_parallelism: int = 4
    node_lease_parallelism: int = 4
    #: 0 disables leases entirely (manage pods ignores leases,
    #: reference controller.go:229-234)
    node_lease_duration_seconds: int = 40
    cidr: str = "10.0.0.1/24"
    node_ip: str = "10.0.0.1"
    node_name: str = "kwok-controller"
    node_port: int = 10247
    enable_crds: bool = False
    #: simulation backend: "host" (per-object reference semantics) or
    #: "device" (vectorized TPU tick kernel, host fallback per kind when
    #: a stage set does not lower)
    backend: str = "host"
    device_capacity: int = 4096
    device_tick_ms: int = 100
    #: 0 = single device; N>1 = shard SoA rows over an N-device mesh
    #: (SURVEY §2.9 scale-out; needs N visible jax devices)
    device_mesh_devices: int = 0

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "KwokConfiguration":
        opts = d.get("options") or d
        def g(key: str, default):
            return opts.get(key, default)
        return cls(
            id=g("id", "kwok-controller"),
            manage_all_nodes=bool(g("manageAllNodes", False)),
            manage_nodes_with_annotation_selector=g("manageNodesWithAnnotationSelector", ""),
            manage_nodes_with_label_selector=g("manageNodesWithLabelSelector", ""),
            disregard_status_with_annotation_selector=g(
                "disregardStatusWithAnnotationSelector", ""
            ),
            disregard_status_with_label_selector=g("disregardStatusWithLabelSelector", ""),
            node_play_stage_parallelism=int(g("nodePlayStageParallelism", 4)),
            pod_play_stage_parallelism=int(g("podPlayStageParallelism", 4)),
            node_lease_parallelism=int(g("nodeLeaseParallelism", 4)),
            node_lease_duration_seconds=int(g("nodeLeaseDurationSeconds", 40)),
            cidr=g("cidr", "10.0.0.1/24"),
            node_ip=g("nodeIP", "10.0.0.1"),
            node_name=g("nodeName", "kwok-controller"),
            node_port=int(g("nodePort", 10247)),
            enable_crds=bool(g("enableCRDs", False)),
            backend=g("backend", "host"),
            device_capacity=int(g("deviceCapacity", 4096)),
            device_tick_ms=int(g("deviceTickMilliseconds", 100)),
            device_mesh_devices=int(g("deviceMeshDevices", 0)),
        )
