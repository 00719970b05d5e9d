"""StageController: the generic stage player for arbitrary resource
kinds (CRs) — the reference's dynamic-client/unstructured path.

(reference: pkg/kwok/controllers/stage_controller.go:49-378)

Any kind registered in the store can be driven through Stages; patches
carry impersonation through to the store's audit trail
(stage_controller.go:341-378 patchResource).
"""

from __future__ import annotations

from typing import Callable, Optional

from kwok_tpu_torch.cluster.informer import Informer, WatchOptions
from kwok_tpu_torch.cluster.store import ResourceStore
from kwok_tpu_torch.controllers.base import StagePlayer
from kwok_tpu_torch.engine.lifecycle import Lifecycle


class StageController(StagePlayer):
    def __init__(
        self,
        store: ResourceStore,
        kind: str,
        lifecycle_getter: Callable[[], Lifecycle],
        predicate: Optional[Callable[[dict], bool]] = None,
        **kw,
    ):
        super().__init__(store, kind, lifecycle_getter, **kw)
        self._predicate = predicate
        self._informer = Informer(store, kind)
        self.cache = None

    def start(self) -> None:
        self.cache = self._informer.watch_with_cache(
            WatchOptions(predicate=self._predicate), self.events, done=self._done
        )
        super().start()
