"""StagesManager: watch Stage CRs, group them by resourceRef, and run a
stage controller per referenced kind with a live lifecycle.

(reference: pkg/kwok/controllers/stages_manager.go:38-122)
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, List, Optional

from kwok_tpu_torch.api.types import Stage
from kwok_tpu_torch.cluster.informer import Informer, WatchOptions
from kwok_tpu_torch.cluster.store import DELETED, ResourceStore
from kwok_tpu_torch.engine.lifecycle import Lifecycle
from kwok_tpu_torch.utils.queue import Queue


class StagesManager:
    """Keeps per-kind Lifecycles in sync with Stage CRs and notifies the
    controller facade to start/stop per-kind stage controllers."""

    def __init__(
        self,
        store: ResourceStore,
        on_ref_added: Callable[[str], None],
        on_ref_removed: Optional[Callable[[str], None]] = None,
        on_ref_updated: Optional[Callable[[str], None]] = None,
    ):
        self._store = store
        self._on_ref_added = on_ref_added
        self._on_ref_removed = on_ref_removed
        #: fired when an existing kind's stage set changes — lets AOT
        #: (device) backends recompile; host backends see the change
        #: through the live lifecycle getter already
        self._on_ref_updated = on_ref_updated
        self._mut = threading.Lock()
        #: kind -> {stage name -> Stage}
        self._by_ref: Dict[str, Dict[str, Stage]] = {}
        self._lifecycles: Dict[str, Lifecycle] = {}
        self._events: Queue = Queue()
        self._done = threading.Event()
        self._informer = Informer(store, "Stage")

    def start(self) -> None:
        self._informer.watch_with_cache(WatchOptions(), self._events, done=self._done)
        t = threading.Thread(target=self._manage, daemon=True)
        t.start()

    def stop(self) -> None:
        self._done.set()

    def lifecycle_getter(self, kind: str) -> Callable[[], Lifecycle]:
        """Live getter: re-resolves after every Stage CR change."""

        def get() -> Lifecycle:
            with self._mut:
                lc = self._lifecycles.get(kind)
                if lc is None:
                    lc = Lifecycle([])
                    self._lifecycles[kind] = lc
                return lc

        return get

    def set_local_stages(self, kind: str, stages: List[Stage]) -> None:
        """Static (non-CRD) stage configuration for one kind
        (reference controller.go:539-549 LocalStages)."""
        with self._mut:
            self._by_ref[kind] = {s.name: s for s in stages}
            self._lifecycles[kind] = Lifecycle(stages)
        self._on_ref_added(kind)

    def _manage(self) -> None:
        """(reference stages_manager.go:72-122 manage loop)"""
        while not self._done.is_set():
            ev, ok = self._events.get_or_wait(timeout=0.2)
            if not ok:
                continue
            try:
                stage = Stage.from_dict(ev.object)
            except (KeyError, TypeError, ValueError):
                continue
            kind = stage.resource_ref.kind
            with self._mut:
                group = self._by_ref.setdefault(kind, {})
                fresh_ref = not group
                if ev.type == DELETED:
                    group.pop(stage.name, None)
                    fresh_ref = False
                else:
                    group[stage.name] = stage
                self._lifecycles[kind] = Lifecycle(list(group.values()))
                empty = not group
            if fresh_ref:
                self._on_ref_added(kind)
            elif not empty and self._on_ref_updated is not None:
                self._on_ref_updated(kind)
            if empty and self._on_ref_removed is not None:
                self._on_ref_removed(kind)
