"""NodeController: simulated kubelet node-status reporting.

(reference: pkg/kwok/controllers/node_controller.go:46-531)

Plays node stages (initialize/heartbeat/chaos) over managed nodes and
exposes the template env funcs NodeIP/NodeName/NodePort
(node_controller.go:521-531). The managed-node *set* lives in the
Controller facade (reference controller.go keeps it in init,
independent of whether node stages exist).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

from kwok_tpu_torch.cluster.informer import Informer, WatchOptions
from kwok_tpu_torch.cluster.store import ResourceStore
from kwok_tpu_torch.controllers.base import StagePlayer
from kwok_tpu_torch.engine.lifecycle import Lifecycle


def node_funcs(node_ip: str, node_name: str, node_port: int) -> Dict[str, Callable]:
    """Node template env funcs, shared by host and device backends
    (reference node_controller.go:521-531)."""
    return {
        "NodeIP": lambda: node_ip,
        "NodeName": lambda: node_name,
        "NodePort": lambda: node_port,
    }


class NodeController(StagePlayer):
    def __init__(
        self,
        store: ResourceStore,
        lifecycle_getter: Callable[[], Lifecycle],
        node_ip: str = "10.0.0.1",
        node_name: str = "kwok-controller",
        node_port: int = 10247,
        predicate: Optional[Callable[[dict], bool]] = None,
        **kw,
    ):
        super().__init__(store, "Node", lifecycle_getter, funcs_for=self._funcs, **kw)
        self.node_ip = node_ip
        self.node_name = node_name
        self.node_port = node_port
        self._predicate = predicate
        self._informer = Informer(store, "Node")
        self.cache = None

    def _funcs(self, obj: dict) -> Dict[str, Callable]:
        return node_funcs(self.node_ip, self.node_name, self.node_port)

    def start(self) -> None:
        self.cache = self._informer.watch_with_cache(
            WatchOptions(predicate=self._predicate), self.events, done=self._done
        )
        super().start()

    def manage_node(self, node_name: str) -> None:
        """Re-feed one node into preprocess (reference ManageNode,
        controller.go:307-329 nodeLeaseSyncWorker path)."""
        if self.cache is None:
            return
        node = self.cache.get(node_name)
        if node is not None:
            self.preprocess_q.add(node)
