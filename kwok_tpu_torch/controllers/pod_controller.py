"""PodController: plays pod stages for pods on managed nodes; allocates
and recycles pod IPs from per-node CIDR pools.

(reference: pkg/kwok/controllers/pod_controller.go:49-672)

``PodEnv`` carries the IP pools + template env funcs so the host
backend (this controller) and the device backend (DeviceStagePlayer)
share identical pod semantics.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, Optional

from kwok_tpu_torch.cluster.informer import CacheGetter, Informer, WatchOptions
from kwok_tpu_torch.cluster.store import ResourceStore
from kwok_tpu_torch.controllers.base import StagePlayer
from kwok_tpu_torch.controllers.utils import IPPool
from kwok_tpu_torch.engine.lifecycle import Lifecycle


class PodEnv:
    """Pod IP allocation + template env funcs, backend-agnostic."""

    def __init__(
        self,
        cidr: str = "10.0.0.1/24",
        node_ip: str = "10.0.0.1",
        node_getter: Optional[CacheGetter] = None,
        cni=None,
    ):
        self.default_cidr = cidr
        self.node_ip = node_ip
        self.node_getter = node_getter
        #: optional CNI backend (kwok_tpu_torch.cni) replacing the pool path —
        #: the reference's --experimental-enable-cni seam
        #: (reference pkg/kwok/cni/cni_linux.go)
        self.cni = cni
        self._pools: Dict[str, IPPool] = {}
        self._pool_mut = threading.Lock()
        #: uid -> (ip, owning pool); the pool is recorded at allocation
        #: time so release is exact even if the node (and its podCIDR)
        #: is gone by then (reference pod_controller.go:481-535)
        self._pod_ips: Dict[str, tuple] = {}

    def _pool_for_locked(self, node_name: str) -> IPPool:
        cidr = self.default_cidr
        if self.node_getter is not None:
            node = self.node_getter.get(node_name)
            if node is not None:
                cidr = ((node.get("spec") or {}).get("podCIDR")) or cidr
        pool = self._pools.get(cidr)
        if pool is None:
            pool = IPPool(cidr)
            self._pools[cidr] = pool
        return pool

    def pod_ip_for(self, pod: dict) -> str:
        """Stable pod IP: host-network pods take the node IP; others get a
        pool IP keyed by uid (reference pod_controller.go:481-535)."""
        if (pod.get("spec") or {}).get("hostNetwork"):
            return self.node_ip_for((pod.get("spec") or {}).get("nodeName") or "")
        if self.cni is not None:
            return self.cni.add(pod)
        uid = (pod.get("metadata") or {}).get("uid") or ""
        existing = (pod.get("status") or {}).get("podIP")
        node = (pod.get("spec") or {}).get("nodeName") or ""
        # single critical section: concurrent plays for one pod (e.g. a
        # SYNC plus a watch event) must not double-allocate
        with self._pool_mut:
            hit = self._pod_ips.get(uid)
            if hit is not None:
                return hit[0]
            pool = self._pool_for_locked(node)
            if existing:
                pool.use(existing)
                ip = existing
            else:
                ip = pool.get()
            self._pod_ips[uid] = (ip, pool)
        return ip

    def node_ip_for(self, node_name: str) -> str:
        if self.node_getter is not None:
            node = self.node_getter.get(node_name)
            if node is not None:
                for addr in ((node.get("status") or {}).get("addresses")) or []:
                    if addr.get("type") == "InternalIP" and addr.get("address"):
                        return addr["address"]
        return self.node_ip

    def release(self, pod: dict) -> None:
        if (pod.get("spec") or {}).get("hostNetwork"):
            return  # never allocated: both paths bypass hostNetwork pods
        if self.cni is not None:
            self.cni.delete(pod)
            return
        uid = (pod.get("metadata") or {}).get("uid") or ""
        with self._pool_mut:
            hit = self._pod_ips.pop(uid, None)
        if hit is not None:
            ip, pool = hit
            pool.put(ip)

    def funcs(self, pod: dict) -> Dict[str, Callable]:
        """Template env funcs (reference pod_controller.go:559-615:
        PodIP, PodIPWith, NodeIPWith, plus NodeIP/NodeName/NodePort)."""
        spec = pod.get("spec") or {}
        node = spec.get("nodeName") or ""
        return {
            "PodIP": lambda: self.pod_ip_for(pod),
            "NodeIP": lambda: self.node_ip_for(node),
            "NodeName": lambda: node,
            "NodePort": lambda: 10250,
            "PodIPWith": lambda *a: self.pod_ip_for(pod),
            "NodeIPWith": lambda name="": self.node_ip_for(name or node),
        }


class PodController(StagePlayer):
    def __init__(
        self,
        store: ResourceStore,
        lifecycle_getter: Callable[[], Lifecycle],
        need_manage: Callable[[dict], bool],
        cidr: str = "10.0.0.1/24",
        node_ip: str = "10.0.0.1",
        node_getter: Optional[CacheGetter] = None,
        env: Optional[PodEnv] = None,
        **kw,
    ):
        self.env = env or PodEnv(cidr=cidr, node_ip=node_ip, node_getter=node_getter)
        super().__init__(
            store,
            "Pod",
            lifecycle_getter,
            funcs_for=self.env.funcs,
            on_delete=self.env.release,
            **kw,
        )
        self._need_manage = need_manage
        self._informer = Informer(store, "Pod")
        self.cache = None

    def start(self) -> None:
        self.cache = self._informer.watch_with_cache(
            WatchOptions(predicate=self._need_manage), self.events, done=self._done
        )
        super().start()

    def sync_node(self, node_name: str) -> None:
        """Re-feed pods on a node that just became managed
        (reference controller.go:559-573 podsOnNodeSyncWorker). The
        manage predicate still applies — disregarded pods stay skipped."""
        self._informer.sync(
            WatchOptions(
                field_selector={"spec.nodeName": node_name},
                predicate=self._need_manage,
            ),
            self.events,
        )
