"""The port's own copies of the host modules compile every built-in
stage set into exactly the tables of kwok_tpu's compiler.

kwok_tpu_torch keeps copies of the jax-free host modules (stage API,
kq, templates, compiler) instead of importing kwok_tpu.  These tests
catch drift: the copies must stay the originals with only their import
lines changed, and must produce identical compiled tables.
"""

import re
from pathlib import Path

import numpy as np
import pytest

from kwok_tpu.engine.compiler import CompiledStageSet as JaxSet
from kwok_tpu.stages import ALL_SETS
from kwok_tpu.stages import default_node_stages as jax_node_stages
from kwok_tpu.stages import load_builtin as jax_load
from kwok_tpu_torch.engine.compiler import CompiledStageSet as TorchSet
from kwok_tpu_torch.stages import default_node_stages as torch_node_stages
from kwok_tpu_torch.stages import load_builtin as torch_load

ROOT = Path(__file__).resolve().parent.parent

COPIED = [
    "api/types.py",
    "api/loader.py",
    "utils/kq.py",
    "utils/expression.py",
    "utils/patch.py",
    "utils/sprig.py",
    "utils/gotpl.py",
    "engine/features.py",
    "engine/lifecycle.py",
    "engine/compiler.py",
    "stages/__init__.py",
]


@pytest.mark.parametrize("rel", COPIED)
def test_host_modules_are_copies(rel):
    ref = (ROOT / "kwok_tpu" / rel).read_text().splitlines()
    port = (ROOT / "kwok_tpu_torch" / rel).read_text().splitlines()
    # the one comment that named a module of the reference package
    ref = [line.replace("the DST harness (kwok_tpu.dst)", "the DST harness") for line in ref]
    port = [re.sub(r"\bkwok_tpu_torch\b", "kwok_tpu", line) for line in port]
    assert port == ref


@pytest.mark.parametrize("name", [p.name for p in (ROOT / "kwok_tpu" / "stages").glob("*.yaml")])
def test_stage_yaml_copies(name):
    ref = (ROOT / "kwok_tpu" / "stages" / name).read_bytes()
    assert (ROOT / "kwok_tpu_torch" / "stages" / name).read_bytes() == ref


def objects():
    pod = {
        "apiVersion": "v1",
        "kind": "Pod",
        "metadata": {"name": "p", "namespace": "d", "uid": "u"},
        "spec": {"nodeName": "n0", "containers": [{"name": "c", "image": "img"}]},
        "status": {},
    }
    job = {**pod, "metadata": {**pod["metadata"], "ownerReferences": [{"kind": "Job", "name": "j"}]}}
    init = {**pod, "spec": {**pod["spec"], "initContainers": [{"name": "i", "image": "img"}]}}
    chaos = {
        **pod,
        "metadata": {
            **pod["metadata"],
            "labels": {"pod-container-running-failed.stage.kwok.x-k8s.io": "true"},
            "annotations": {
                "pod-create.stage.kwok.x-k8s.io/delay": "3s",
                "pod-create.stage.kwok.x-k8s.io/jitter-delay": "5s",
                "pod-ready.stage.kwok.x-k8s.io/weight": "4",
            },
        },
    }
    deleting = {**pod, "metadata": {**pod["metadata"], "deletionTimestamp": "2026-01-01T00:00:05Z",
                                    "finalizers": ["kwok.x-k8s.io/fake"]}}
    node = {
        "apiVersion": "v1",
        "kind": "Node",
        "metadata": {"name": "n", "creationTimestamp": "2026-01-01T00:00:00Z"},
        "status": {},
    }
    return [pod, job, init, chaos, deleting, node]


STAGE_SETS = [[s] for s in ALL_SETS] + [["pod-general", "pod-chaos"], ["node-default"], ["node-default-lease"]]


def load(which, names):
    load_builtin, node_stages = which
    if names == ["node-default"]:
        return node_stages(lease=False)
    if names == ["node-default-lease"]:
        return node_stages(lease=True)
    return [s for n in names for s in load_builtin(n)]


@pytest.mark.parametrize("names", STAGE_SETS, ids=["+".join(n) for n in STAGE_SETS])
def test_compiled_tables_identical(names):
    jset = JaxSet(load((jax_load, jax_node_stages), names))
    tset = TorchSet(load((torch_load, torch_node_stages), names))
    for obj in objects():
        assert jset.signature_for(obj) == tset.signature_for(obj)
        assert jset.override_class_for(obj) == tset.override_class_for(obj)
        assert np.array_equal(jset.extract_features(obj), tset.extract_features(obj))
    assert jset.C == tset.C and jset.num_stages == tset.num_stages
    assert [c.key for c in jset.schema.columns] == [c.key for c in tset.schema.columns]
    assert [c.vocab for c in jset.schema.columns] == [c.vocab for c in tset.schema.columns]
    assert [s.name for s in jset.compiled] == [s.name for s in tset.compiled]
    for f in ("cond_col", "cond_mask", "cond_neg", "cond_valid", "w_static", "d_static",
              "j_static", "has_jitter", "d_from_del_ts", "j_from_del_ts", "stage_delete",
              "stage_event", "stage_immediate"):
        a, b = getattr(jset, f), getattr(tset, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    for a, b in zip(jset.effect_tables() + jset.override_tables(),
                    tset.effect_tables() + tset.override_tables()):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert jset.version == tset.version
