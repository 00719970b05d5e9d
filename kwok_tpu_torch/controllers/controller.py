"""Controller facade: validates config, tracks the managed-node set,
wires lease ownership, and starts per-kind stage controllers.

(reference: pkg/kwok/controllers/controller.go:60-573)

Dispatch (controller.go:331-361 startStageController): Stage CRs (or
local stage sets) grouped by resourceRef.kind — ``Pod`` gets the
PodController (IP pools, node funcs), ``Node`` the NodeController (+
lease heartbeats), anything else a generic StageController.

Port of ``kwok_tpu/controllers/controller.py``: the device backend
builds the port's ``DeviceStagePlayer`` and ``DeviceLeaseLane`` on
``device`` (the card unless the caller names one).  With
``device_mesh_devices > 1`` the players shard their rows over that many
distinct cards, or, with ``device="cpu"``, over that many CPU shards.
"""

from __future__ import annotations

import random
import threading
from typing import Dict, List, Optional, Set

from kwok_tpu_torch.api.config import KwokConfiguration
from kwok_tpu_torch.api.types import Stage
from kwok_tpu_torch.cluster.informer import Informer, WatchOptions
from kwok_tpu_torch.cluster.store import (
    DELETED,
    EventRecorder,
    ResourceStore,
    match_label_selector,
)
from kwok_tpu_torch.controllers.node_controller import NodeController
from kwok_tpu_torch.controllers.node_lease_controller import NodeLeaseController
from kwok_tpu_torch.controllers.pod_controller import PodController
from kwok_tpu_torch.controllers.stage_controller import StageController
from kwok_tpu_torch.controllers.stages_manager import StagesManager
from kwok_tpu_torch.ops.device import resolve_device
from kwok_tpu_torch.utils.clock import Clock, RealClock
from kwok_tpu_torch.utils.queue import Queue


def _match_annotations(obj: dict, selector: str) -> bool:
    if not selector:
        return False
    annotations = (obj.get("metadata") or {}).get("annotations") or {}
    fake = {"metadata": {"labels": annotations}}
    return match_label_selector(fake, selector)


class Controller:
    """The kwok controller: starts everything, owns shared state."""

    def __init__(
        self,
        store: ResourceStore,
        config: Optional[KwokConfiguration] = None,
        local_stages: Optional[Dict[str, List[Stage]]] = None,
        clock: Optional[Clock] = None,
        seed: Optional[int] = None,
        device=None,
    ):
        self.store = store
        self.conf = config or KwokConfiguration(manage_all_nodes=True)
        self._validate(self.conf)
        self.clock = clock or RealClock()
        self.rng = random.Random(seed)
        self.recorder = EventRecorder(store, source="kwok", clock=self.clock)
        self._local_stages = local_stages
        self._started = False
        self._mut = threading.Lock()
        self._done = threading.Event()

        #: the managed-node set (reference controller.go init: node
        #: informer + manage selectors, independent of node stages)
        self._managed: Set[str] = set()
        self._managed_mut = threading.Lock()
        self._node_events: Queue = Queue()
        self.node_cache = None

        #: shared device mesh for every device player; built and
        #: validated ONCE here so an oversubscribed mesh fails loudly at
        #: startup instead of killing the Stage-CR manage thread later
        #: torch device of every device player and lease lane: the card
        #: unless the caller names one (resolved, and refused without a
        #: card, only when the device backend is asked for)
        self.device = (
            resolve_device(device) if self.conf.backend == "device" else device
        )
        self._device_mesh = None
        if self.conf.backend == "device" and self.conf.device_mesh_devices > 1:
            from kwok_tpu_torch.parallel.mesh import make_mesh

            n = self.conf.device_mesh_devices
            # CPU shards are the analog of XLA's fake host devices
            self._device_mesh = (
                make_mesh(devices=[self.device] * n)
                if self.device.type == "cpu"
                else make_mesh(n)
            )

        self.nodes: Optional[NodeController] = None
        self.pods: Optional[PodController] = None
        self.node_leases: Optional[NodeLeaseController] = None
        self.stage_controllers: Dict[str, StageController] = {}
        self.device_players: Dict[str, object] = {}
        self.stages_manager = StagesManager(
            store,
            on_ref_added=self._on_ref_added,
            on_ref_updated=self._on_ref_updated,
        )

    @staticmethod
    def _validate(conf: KwokConfiguration) -> None:
        """(reference controller.go:165-175: manage modes are exclusive)"""
        selectors = bool(
            conf.manage_nodes_with_annotation_selector
            or conf.manage_nodes_with_label_selector
        )
        if conf.manage_all_nodes and selectors:
            raise ValueError(
                "manage_all_nodes is mutually exclusive with the node selectors"
            )

    # ---------------------------------------------------------------- manage set

    def _node_managed_by_selector(self, node: dict) -> bool:
        if self.conf.manage_all_nodes:
            return True
        if self.conf.manage_nodes_with_annotation_selector and _match_annotations(
            node, self.conf.manage_nodes_with_annotation_selector
        ):
            return True
        if self.conf.manage_nodes_with_label_selector and match_label_selector(
            node, self.conf.manage_nodes_with_label_selector
        ):
            return True
        return False

    def _disregard(self, obj: dict) -> bool:
        """Objects whose status kwok must leave alone
        (reference pod_controller.go:392-409 need/disregard)."""
        if self.conf.disregard_status_with_annotation_selector and _match_annotations(
            obj, self.conf.disregard_status_with_annotation_selector
        ):
            return True
        if self.conf.disregard_status_with_label_selector and match_label_selector(
            obj, self.conf.disregard_status_with_label_selector
        ):
            return True
        return False

    def _node_predicate(self, node: dict) -> bool:
        return self._node_managed_by_selector(node) and not self._disregard(node)

    def _pod_managed(self, pod: dict) -> bool:
        if self._disregard(pod):
            return False
        node = (pod.get("spec") or {}).get("nodeName") or ""
        if not node:
            return False
        return self.manages(node)

    def manages(self, node_name: str) -> bool:
        with self._managed_mut:
            return node_name in self._managed

    def managed_nodes(self) -> Set[str]:
        with self._managed_mut:
            return set(self._managed)

    def _manage_worker(self) -> None:
        """Consumes node informer events into the managed set and fires
        the lease/ownership callbacks (controller.go:262-296)."""
        while not self._done.is_set():
            ev, ok = self._node_events.get_or_wait(timeout=0.2)
            if not ok:
                continue
            name = (ev.object.get("metadata") or {}).get("name") or ""
            if ev.type == DELETED:
                with self._managed_mut:
                    self._managed.discard(name)
                self._on_node_unmanaged(name)
            else:
                with self._managed_mut:
                    fresh = name not in self._managed
                    self._managed.add(name)
                if fresh:
                    self._on_node_managed(name)

    # ------------------------------------------------------------------- wiring

    def _read_only(self, obj: dict) -> bool:
        """Not holding the node's lease = read-only
        (reference controller.go:286-296)."""
        if self.node_leases is None:
            return False
        kind = obj.get("kind")
        if kind == "Node":
            name = (obj.get("metadata") or {}).get("name") or ""
        else:
            name = (obj.get("spec") or {}).get("nodeName") or ""
            if not name:
                return False
        return not self.node_leases.held(name)

    def _on_node_managed(self, node_name: str) -> None:
        if self.node_leases is not None:
            self.node_leases.try_hold(node_name)
        else:
            self._on_node_owned(node_name)

    def _on_node_owned(self, node_name: str) -> None:
        """Lease acquired (or leases disabled): simulate the node and
        re-feed its pods (reference controller.go:276-279). Device
        players get the same catch-up — events dropped while read-only
        are replayed."""
        if self.nodes is not None:
            self.nodes.manage_node(node_name)
        if self.pods is not None:
            self.pods.sync_node(node_name)
        # a snapshot: the Stage-CR thread may add a player meanwhile
        for dp in list(self.device_players.values()):
            dp.sync_node(node_name)

    def _on_node_unmanaged(self, node_name: str) -> None:
        if self.node_leases is not None:
            self.node_leases.release_hold(node_name)

    def _on_ref_added(self, kind: str) -> None:
        """startStageController dispatch (controller.go:331-361)."""
        with self._mut:
            if not self._started:
                return
            self._start_controller_for(kind)

    def _on_ref_updated(self, kind: str) -> None:
        """A kind's stage set changed: host controllers see it through
        the live lifecycle getter; an AOT-compiled device player must be
        rebuilt against the new set (its informer re-lists the world)."""
        with self._mut:
            if not self._started or self._done.is_set():
                return
            player = self.device_players.pop(kind, None)
            if player is not None:
                player.stop()
                if kind == "Node" and self.node_leases is not None:
                    # the old player's lease lane dies with it; renewals
                    # fall back to the host workers until (and unless) a
                    # new device player re-attaches a lane
                    self.node_leases.detach_device_lane()
            self._start_controller_for(kind)

    def _start_controller_for(self, kind: str) -> None:
        if self.conf.backend == "device" and self._start_device_controller(kind):
            return
        getter = self.stages_manager.lifecycle_getter(kind)
        if kind == "Pod":
            if self.pods is not None:
                return
            self.pods = PodController(
                self.store,
                getter,
                need_manage=self._pod_managed,
                cidr=self.conf.cidr,
                node_ip=self.conf.node_ip,
                node_getter=self.node_cache,
                parallelism=self.conf.pod_play_stage_parallelism,
                clock=self.clock,
                recorder=self.recorder,
                read_only=self._read_only,
                rng=self.rng,
            )
            self.pods.start()
        elif kind == "Node":
            if self.nodes is not None:
                return
            self.nodes = NodeController(
                self.store,
                getter,
                node_ip=self.conf.node_ip,
                node_name=self.conf.node_name,
                node_port=self.conf.node_port,
                predicate=self._node_predicate,
                parallelism=self.conf.node_play_stage_parallelism,
                clock=self.clock,
                recorder=self.recorder,
                read_only=self._read_only,
                rng=self.rng,
            )
            self.nodes.start()
        else:
            if kind in self.stage_controllers:
                return
            sc = StageController(
                self.store,
                kind,
                getter,
                clock=self.clock,
                recorder=self.recorder,
                rng=self.rng,
            )
            self.stage_controllers[kind] = sc
            sc.start()

    def _start_device_controller(self, kind: str) -> bool:
        """Try the vectorized device backend for this kind; returns
        False (host fallback) when the stage set does not lower to the
        AOT tick kernel (SURVEY.md §7.1 compile-time vocabulary split)."""
        from kwok_tpu_torch.controllers.device_player import DeviceStagePlayer
        from kwok_tpu_torch.controllers.pod_controller import PodEnv
        from kwok_tpu_torch.engine.compiler import StageCompileError

        if kind in self.device_players:
            return True
        stages = self._stages_for(kind)
        if not stages:
            return False
        predicate = None
        funcs_for = None
        on_delete = None
        if kind == "Pod":
            env = PodEnv(
                cidr=self.conf.cidr,
                node_ip=self.conf.node_ip,
                node_getter=self.node_cache,
            )
            predicate = self._pod_managed
            funcs_for = env.funcs
            on_delete = env.release
        elif kind == "Node":
            from kwok_tpu_torch.controllers.node_controller import node_funcs

            predicate = self._node_predicate
            nf = node_funcs(self.conf.node_ip, self.conf.node_name, self.conf.node_port)
            funcs_for = lambda obj: nf  # noqa: E731
        try:
            player = DeviceStagePlayer(
                self.store,
                kind,
                stages,
                capacity=self.conf.device_capacity,
                tick_ms=self.conf.device_tick_ms,
                clock=self.clock,
                recorder=self.recorder,
                read_only=self._read_only,
                predicate=predicate,
                funcs_for=funcs_for,
                on_delete=on_delete,
                seed=self.rng.randrange(2**31),
                mesh=self._device_mesh,
                device=self.device,
            )
        except StageCompileError:
            return False
        if kind == "Node" and self.node_leases is not None:
            # lease renewals ride the node player's device tick
            # (SURVEY §7 step 5): held leases register on a vectorized
            # fire-time lane; due rows drain as one bulk write-back.
            # Nodes already cycling through the host path migrate on
            # their next requeue pop.
            from kwok_tpu_torch.controllers.device_lease import DeviceLeaseLane

            lane = DeviceLeaseLane(
                self.node_leases,
                capacity=self.conf.device_capacity,
                seed=self.rng.randrange(2**31),
                device=self.device,
            )
            self.node_leases.attach_device_lane(lane)
            player.post_tick = lane.tick
        self.device_players[kind] = player
        player.start()
        return True

    def _stages_for(self, kind: str) -> List[Stage]:
        if self._local_stages is not None:
            return self._local_stages.get(kind) or []
        lc = self.stages_manager.lifecycle_getter(kind)()
        return [cs.raw for cs in lc.stages]

    def start(self) -> None:
        """(reference controller.go:533-557 Start)"""
        with self._mut:
            if self._started:
                return
            self._started = True
            if self.conf.node_lease_duration_seconds > 0:
                self.node_leases = NodeLeaseController(
                    self.store,
                    holder_identity=self.conf.id,
                    lease_duration_seconds=self.conf.node_lease_duration_seconds,
                    parallelism=self.conf.node_lease_parallelism,
                    clock=self.clock,
                    on_node_managed=self._on_node_owned,
                    mutate_lease=self._set_lease_owner,
                    rng=self.rng,
                )
                self.node_leases.start()
            # the facade's own managed-node tracking
            self.node_cache = Informer(self.store, "Node").watch_with_cache(
                WatchOptions(predicate=self._node_predicate),
                self._node_events,
                done=self._done,
            )
            t = threading.Thread(target=self._manage_worker, daemon=True)
            t.start()
        if self._local_stages is not None:
            # Node first so node funcs/caches exist before pods play
            for kind in sorted(self._local_stages, key=lambda k: k != "Node"):
                self.stages_manager.set_local_stages(kind, self._local_stages[kind])
        else:
            self.stages_manager.start()

    def _set_lease_owner(self, lease: dict) -> dict:
        """ownerReference to the node (reference controller.go
        setNodeOwnerFunc)."""
        name = (lease.get("metadata") or {}).get("name") or ""
        node = self.node_cache.get(name) if self.node_cache is not None else None
        if node is not None:
            lease.setdefault("metadata", {})["ownerReferences"] = [
                {
                    "apiVersion": "v1",
                    "kind": "Node",
                    "name": name,
                    "uid": (node.get("metadata") or {}).get("uid"),
                }
            ]
        return lease

    def stop(self) -> None:
        self._done.set()
        self.stages_manager.stop()
        for c in (self.nodes, self.pods, self.node_leases):
            if c is not None:
                c.stop()
        for sc in self.stage_controllers.values():
            sc.stop()
        with self._mut:
            players = list(self.device_players.values())
        for dp in players:
            dp.stop()

    # -------------------------------------------------------------------- stats

    def transition_count(self) -> int:
        total = 0
        for c in [
            self.nodes,
            self.pods,
            *self.stage_controllers.values(),
            *self.device_players.values(),
        ]:
            if c is not None:
                total += c.transitions
        return total
