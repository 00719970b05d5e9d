"""Shared stage-playing hot loop for node/pod/generic controllers.

The reference repeats this loop three times (node_controller.go,
pod_controller.go, stage_controller.go); here it is factored once:

    informer event -> preprocess (dedup by resourceVersion ->
    Lifecycle.select -> delay) -> WeightDelayingQueue(weight 0 fresh /
    1 retry) -> play-stage workers -> event / finalizer JSON-patch /
    delete / rendered patches with no-op elision -> store PATCH ->
    immediateNextStage re-feeds the result.

(reference: pkg/kwok/controllers/pod_controller.go:176-360,
node_controller.go:144-424, stage_controller.go:268-338)

This is the *host* backend: per-object, arbitrary jq/templates. The
device backend batches rows through the tick kernel behind the same
seam (SURVEY.md §7.3).
"""

from __future__ import annotations

import datetime
import random
import threading
import traceback
from typing import Callable, Dict, List, Optional

from kwok_tpu_torch.cluster.informer import InformerEvent
from kwok_tpu_torch.cluster.store import DELETED, EventRecorder, NotFound, ResourceStore
from kwok_tpu_torch.controllers.utils import Backoff, StageJob, should_retry
from kwok_tpu_torch.engine.lifecycle import CompiledStage, Lifecycle, to_json_standard
from kwok_tpu_torch.utils.clock import Clock, RealClock
from kwok_tpu_torch.utils.patch import is_noop_patch
from kwok_tpu_torch.utils.queue import (
    Queue,
    WeightDelayingQueue,
    new_weight_delaying_queue,
)


class StagePlayer:
    """One controller's preprocess + play loop over a resource kind."""

    def __init__(
        self,
        store: ResourceStore,
        kind: str,
        lifecycle_getter: Callable[[], Lifecycle],
        parallelism: int = 4,
        clock: Optional[Clock] = None,
        recorder: Optional[EventRecorder] = None,
        read_only: Optional[Callable[[dict], bool]] = None,
        funcs_for: Optional[Callable[[dict], Dict[str, Callable]]] = None,
        on_delete: Optional[Callable[[dict], None]] = None,
        rng: Optional[random.Random] = None,
    ):
        self.store = store
        self.kind = kind
        self._lifecycle_getter = lifecycle_getter
        self.clock = clock or RealClock()
        self.recorder = recorder
        self.read_only = read_only
        self.funcs_for = funcs_for or (lambda obj: {})
        self.on_delete = on_delete
        self.rng = rng or random.Random()
        self.backoff = Backoff()

        self.events: Queue = Queue()
        self.preprocess_q: Queue = Queue()
        self.delay_queue: WeightDelayingQueue = new_weight_delaying_queue(self.clock)
        #: key -> (rv, job): dedup + cancellation of superseded jobs
        #: (reference pod_controller.go:205-214 delayQueueMapping)
        self.delay_queue_mapping: Dict[str, StageJob] = {}
        self._map_mut = threading.Lock()

        self._done = threading.Event()
        self._threads: List[threading.Thread] = []
        self._parallelism = parallelism
        # transition counters (observability; the bench reads these)
        self.transitions = 0
        self.patches = 0
        self._stat_mut = threading.Lock()

    # ------------------------------------------------------------------- wiring

    def start(self) -> None:
        t = threading.Thread(target=self._event_worker, daemon=True)
        t.start()
        self._threads.append(t)
        t = threading.Thread(target=self._preprocess_worker, daemon=True)
        t.start()
        self._threads.append(t)
        for _ in range(self._parallelism):
            t = threading.Thread(target=self._play_stage_worker, daemon=True)
            t.start()
            self._threads.append(t)

    def stop(self) -> None:
        self._done.set()
        self.delay_queue.stop()

    @property
    def lifecycle(self) -> Lifecycle:
        return self._lifecycle_getter()

    def _key(self, obj: dict) -> str:
        meta = obj.get("metadata") or {}
        return f"{meta.get('namespace', '')}/{meta.get('name', '')}"

    # ---------------------------------------------------------------- hot loop

    def _event_worker(self) -> None:
        while not self._done.is_set():
            ev, ok = self.events.get_or_wait(timeout=0.2)
            if not ok:
                continue
            try:
                self.handle_event(ev)
            except Exception:  # noqa: BLE001 — one bad event (e.g. a CNI
                # release failure) must not kill the event loop; the
                # preprocess/play workers guard the same way
                traceback.print_exc()

    def handle_event(self, ev: InformerEvent) -> None:
        obj = ev.object
        if ev.type == DELETED:
            with self._map_mut:
                job = self.delay_queue_mapping.pop(self._key(obj), None)
            if job is not None:
                self.delay_queue.cancel(job)
            if self.on_delete is not None:
                self.on_delete(obj)
            return
        if self.read_only is not None and self.read_only(obj):
            return
        # the causing write's span context travels with the object
        # through preprocess -> delay queue -> play (watch-boundary
        # stitch; None with tracing off)
        self.preprocess_q.add((obj, getattr(ev, "ctx", None)))

    def _preprocess_worker(self) -> None:
        while not self._done.is_set():
            item, ok = self.preprocess_q.get_or_wait(timeout=0.2)
            if not ok:
                continue
            # bare objects still arrive from ctx-less re-feeds
            # (node_controller.manage_node) — tolerate both shapes
            obj, ctx = item if isinstance(item, tuple) else (item, None)
            try:
                self.preprocess(obj, ctx=ctx)
            except Exception:  # noqa: BLE001 — a bad object must not kill the loop
                import traceback

                traceback.print_exc()

    def preprocess(self, obj: dict, ctx=None) -> None:
        """Match + delay + enqueue (reference pod_controller.go:196-254)."""
        key = self._key(obj)
        meta = obj.get("metadata") or {}
        rv = meta.get("resourceVersion")
        with self._map_mut:
            prev = self.delay_queue_mapping.get(key)
            if prev is not None:
                prev_rv = (prev.resource.get("metadata") or {}).get("resourceVersion")
                if prev_rv == rv:
                    return  # already queued for this version

        data = to_json_standard(obj)
        lc = self.lifecycle
        stage = lc.select(
            meta.get("labels") or {}, meta.get("annotations") or {}, data, rng=self.rng
        )
        if stage is None:
            return
        now = datetime.datetime.fromtimestamp(self.clock.now(), datetime.timezone.utc)
        delay, _ = stage.delay(data, now, rng=self.rng)
        job = StageJob(resource=obj, stage=stage, key=key, ctx=ctx)
        self.add_stage_job(job, delay, weight=0)

    def add_stage_job(self, job: StageJob, delay: float, weight: int) -> None:
        """Enqueue, cancelling any older job for the same key
        (reference pod_controller.go:660-671)."""
        with self._map_mut:
            old = self.delay_queue_mapping.get(job.key)
            self.delay_queue_mapping[job.key] = job
        if old is not None and old is not job:
            self.delay_queue.cancel(old)
        self.delay_queue.add_weight_after(job, weight, delay)

    def add_retry_job(self, job: StageJob, delay: float) -> None:
        """Re-queue a failed job at lower priority — unless a newer job
        for the same key arrived meanwhile (the retry must not clobber a
        fresher resourceVersion)."""
        with self._map_mut:
            if job.key in self.delay_queue_mapping:
                return
            self.delay_queue_mapping[job.key] = job
        self.delay_queue.add_weight_after(job, 1, delay)

    def _play_stage_worker(self) -> None:
        while not self._done.is_set():
            job, ok = self.delay_queue.get_or_wait(timeout=0.2)
            if not ok:
                continue
            with self._map_mut:
                if self.delay_queue_mapping.get(job.key) is job:
                    del self.delay_queue_mapping[job.key]
            try:
                need_retry = self.play_stage(job.resource, job.stage, ctx=job.ctx)
            except Exception:  # noqa: BLE001
                import traceback

                traceback.print_exc()
                continue
            if need_retry:
                retry = job.retry_count
                job.retry_count += 1
                self.add_retry_job(job, self.backoff.delay(retry, self.rng))

    # ------------------------------------------------------------- stage effects

    def now_func(self) -> str:
        t = datetime.datetime.fromtimestamp(self.clock.now(), datetime.timezone.utc)
        return t.isoformat(timespec="microseconds").replace("+00:00", "Z")

    def play_stage(self, obj: dict, stage: CompiledStage, ctx=None) -> bool:
        """Apply one stage's effects; returns need_retry
        (reference pod_controller.go:290-360 playStage).  ``ctx``
        (the causing write's span context, stitched across the watch
        boundary) makes the play span a continuation of — and a link
        to — that write's trace; immediate-next-stage re-feeds carry
        the play span's own context so the whole stage chain stays one
        trace."""
        from kwok_tpu_torch.utils.trace import get_tracer

        tracer = get_tracer()
        if tracer.enabled:
            meta = obj.get("metadata") or {}
            tid, pid = ctx if ctx else (None, None)
            with tracer.span(f"play.{self.kind}", trace_id=tid, parent_id=pid) as sp:
                if ctx:
                    sp.add_link(*ctx)
                sp.set("stage", stage.name)
                sp.set("object", f"{meta.get('namespace', '')}/{meta.get('name', '')}")
                return self._play_stage_inner(
                    obj, stage, refeed_ctx=(sp.trace_id, sp.span_id)
                )
        return self._play_stage_inner(obj, stage)

    def _play_stage_inner(self, obj: dict, stage: CompiledStage, refeed_ctx=None) -> bool:
        lc = self.lifecycle
        effects = lc.effects(stage)
        if effects is None:
            return False
        meta = obj.get("metadata") or {}
        name = meta.get("name") or ""
        ns = meta.get("namespace")
        result: Optional[dict] = None

        if effects.event is not None and self.recorder is not None:
            ev = effects.event
            self.recorder.event(obj, ev.type or "Normal", ev.reason, ev.message)

        fin = effects.finalizers_patch(meta.get("finalizers") or [])
        if fin is not None:
            try:
                result = self.store.patch(self.kind, name, fin.data, fin.type, namespace=ns)
            except NotFound:
                return False
            except Exception as e:  # noqa: BLE001
                return should_retry(e)

        if effects.delete:
            try:
                self.store.delete(self.kind, name, namespace=ns)
            except NotFound:
                pass
            except Exception as e:  # noqa: BLE001
                return should_retry(e)
            result = None
        else:
            funcs = dict(self.funcs_for(obj))
            funcs.setdefault("Now", self.now_func)
            base = result if result is not None else obj
            for patch in effects.patches(base, funcs):
                if is_noop_patch(base, patch.data, patch.type):
                    continue  # no-op elision (reference utils.go:162-214)
                try:
                    result = self.store.patch(
                        self.kind,
                        name,
                        patch.data,
                        patch.type,
                        namespace=ns,
                        subresource=patch.subresource,
                        as_user=patch.impersonation,
                    )
                    base = result
                    with self._stat_mut:
                        self.patches += 1
                except NotFound:
                    return False
                except Exception as e:  # noqa: BLE001
                    return should_retry(e)

        with self._stat_mut:
            self.transitions += 1
        if result is not None and stage.immediate_next_stage:
            self.preprocess_q.add((result, refeed_ctx))
        return False
