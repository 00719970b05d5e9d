"""The native pass of the admission keys (``native/admitkeys.c``).

Over a seeded corpus (the placed cell's pods and nodes, and objects with
shuffled key orders, nested and empty containers, non-ASCII, astral and
control characters, quotes and backslashes, big ints, negative zero,
floats at the edges of their repr, NaN and the infinities, ``True``
beside ``1``) the pass writes the texts that ``json.dumps`` writes on the
Python path, byte for byte: the signature key's and the regions key's.
It refuses every object that is not JSON-standard, and such an object
takes the Python path.  Two simulators, one with ``KWOK_TPU_NATIVE=0``,
hold the same columns, tables and card rows after the same admissions
and refreshes, and ``kwok_sim_admit_keys_total`` counts each
classification once, on the path its keys took.
"""

import datetime
import json
import random

import numpy as np
import pytest

from kwok_tpu_torch.engine import simulator as simmod
from kwok_tpu_torch.engine.behaviour import ITER, Regions, project
from kwok_tpu_torch.engine.simulator import DeviceSimulator
from kwok_tpu_torch.native import admitkeys
from kwok_tpu_torch.utils import telemetry

from kwokbench import promtext, simphase, spec
from kwokbench.drivers import simulator_placed as placed
from kwokbench.drivers.simulator import stage_list

SEED = 3_000_000_019
CELL = "placed-mixed-10k.sim"

TEXT = ["a", "Z", "0", " ", "~", '"', "\\", "/", "\n", "\r", "\t", "\b", "\f", "\x00", "\x1f",
        "\x7f", "\x80", "é", "ß", "ÿ", "中", " ", "\ud800", "\udfff", "�", "😀",
        "\U0001f9d1", "\U0010ffff"]
NUMBERS = [0, 1, -1, 2**31, 2**63 - 1, -2**63, 2**63, 2**64 + 5, -(2**200), 10**300, True, False,
           None, 0.0, -0.0, 1.0, -1.5, 0.1, 0.1 + 0.2, 1 / 3, 1e16, 1e17, 9007199254740993.0,
           1e-5, 1e-7, 123456789.125, 5e-324, 2.2250738585072014e-308, 1.7976931348623157e308,
           float("nan"), float("inf"), float("-inf")]


@pytest.fixture(scope="module")
def native():
    mod = admitkeys.load()
    if mod is None:
        pytest.skip("the admitkeys extension cannot be built here (no g++ or Python.h)")
    return mod


def signature_text(obj):
    """What ``CompiledStageSet._signature_key`` hashes."""
    meta = obj.get("metadata") or {}
    return json.dumps({"spec": obj.get("spec"), "labels": meta.get("labels"),
                       "annotations": meta.get("annotations"),
                       "ownerReferences": meta.get("ownerReferences")}, sort_keys=True, default=str)


def placed_cell(n_pods=2000, n_nodes=256, seed=SEED):
    cfg = spec.load_cell(CELL).config
    layout = placed.Layout(cfg, n_pods, np.random.default_rng(seed))
    objects = placed.Objects(cfg, layout, n_nodes, seed)
    return cfg, [objects.node(i) for i in range(n_nodes)], [objects.pod(r) for r in range(n_pods)]


def regions_of(cfg):
    return {kind: Regions(DeviceSimulator(stage_list(cfg[f"{kind.lower()}_stages"]), capacity=8,
                                          device="cpu").cset) for kind in ("Pod", "Node")}


class Corpus:
    """Seeded objects shaped as Kubernetes objects, of every kind of value."""

    def __init__(self, seed):
        self.rng = random.Random(seed)

    def text(self, n=6):
        return "".join(self.rng.choice(TEXT) for _ in range(self.rng.randint(0, n)))

    def scalar(self):
        return self.rng.choice([self.text(), self.rng.choice(NUMBERS), self.rng.choice(TEXT)])

    def value(self, depth=0):
        r = self.rng.random()
        if depth > 4 or r < 0.45:
            return self.scalar()
        if r < 0.75:
            return self.mapping(depth)
        return [self.value(depth + 1) for _ in range(self.rng.randint(0, 4))]

    def mapping(self, depth, keys=()):
        keys = list(keys) + [self.text() for _ in range(self.rng.randint(0, 4))]
        self.rng.shuffle(keys)
        return {k: self.value(depth + 1) for k in keys}

    def obj(self):
        rng = self.rng
        meta = self.mapping(1, ["name", "labels", "annotations", "ownerReferences",
                                "deletionTimestamp"])
        spec = self.mapping(1, ["nodeName", "containers", "initContainers", "readinessGates"])
        spec["containers"] = [self.mapping(2, ["name", "image"]) for _ in range(rng.randint(0, 3))]
        out = {"apiVersion": "v1", "kind": rng.choice(["Pod", "Node"]), "status": self.value(1)}
        if rng.random() < 0.9:
            out["metadata"] = meta if rng.random() < 0.9 else rng.choice([None, {}, [], "", 0])
        if rng.random() < 0.9:
            out["spec"] = spec
        items = list(out.items())
        rng.shuffle(items)
        return dict(items)


#: a trie with every kind of step: whole subtrees, named steps, ITER
#: steps to whole elements and to named steps, and steps no object has
SYNTHETIC_TRIE = {
    "metadata": {"labels": {"a": None, "é": None, "😀": None}, "annotations": None},
    "spec": {"containers": {ITER: {"name": None, "image": None}}, "nodeName": None,
             "readinessGates": {ITER: None}, "nothing": {"here": None}},
    "status": {ITER: None},
}


def corpus(section):
    if section == "placed":
        _, nodes, pods = placed_cell()
        return nodes + pods
    c = Corpus(SEED + len(section))
    if section == "random":
        return [c.obj() for _ in range(3000)]
    if section == "scalars":  # every scalar where each key reads it
        return [{"metadata": {"labels": {"a": x, "b": [x]}, "annotations": {"x": x}},
                 "spec": {"nodeName": x, "containers": [{"name": x, "image": x}]}, "status": x}
                for x in NUMBERS + TEXT]
    assert section == "empty"
    return [{}, {"metadata": None}, {"metadata": {}}, {"metadata": []}, {"metadata": ""},
            {"spec": {}}, {"spec": []}, {"spec": [[]]},
            {"metadata": {"labels": {}}, "spec": {"": ""}},
            {"status": {"conditions": []}, "spec": {"containers": []}}]


@pytest.mark.parametrize("section", ["placed", "random", "scalars", "empty"])
def test_texts_are_json_dumps_byte_for_byte(native, section):
    cfg = spec.load_cell(CELL).config
    tries = [r.trie for r in regions_of(cfg).values()] + [SYNTHETIC_TRIE, {}]
    compiled = [native.compile_trie(t, ITER) for t in tries]
    objs = corpus(section)
    assert len(objs) >= 10
    for obj in objs:
        for trie, cap in zip(tries, compiled):
            keys = native.keys(cap, obj)
            assert keys is not None, obj
            sig, region = keys
            assert sig == signature_text(obj)
            assert region == json.dumps(project(obj, trie), sort_keys=True, default=str)
            assert sig.isascii() and region.isascii()


def test_regions_keys_of_the_placed_cell_are_the_python_keys(native):
    cfg, nodes, pods = placed_cell(n_pods=500)
    for kind, objs in (("Node", nodes), ("Pod", pods)):
        regions = regions_of(cfg)[kind]
        cap = native.compile_trie(regions.trie, ITER)
        for obj in objs:
            assert native.keys(cap, obj) == (signature_text(obj), regions.key(obj))


class Text(str):
    pass


REFUSED = {
    "datetime": datetime.datetime(2026, 1, 1, tzinfo=datetime.timezone.utc),
    "date": datetime.date(2026, 1, 1),
    "tuple": ("a", "b"),
    "str_subclass": Text("x"),
    "numpy_scalar": np.int64(3),
    "numpy_float": np.float32(0.5),
    "set": {"a"},
    "bytes": b"x",
}


def with_value(value, where):
    obj = {"apiVersion": "v1", "kind": "Pod",
           "metadata": {"name": "p", "labels": {"app": "a"}},
           "spec": {"nodeName": "n0", "containers": [{"name": "c", "image": "img"}]},
           "status": {}}
    if where == "label":
        obj["metadata"]["labels"]["when"] = value
    elif where == "spec":
        obj["spec"]["containers"][0]["args"] = [value]
    else:  # a part neither key reads
        obj["status"]["startTime"] = value
    return obj


def refused_objects():
    out = [pytest.param(kind, where, id=f"{kind}-{where}")
           for kind in sorted(REFUSED) for where in ("label", "spec", "status")]
    out += [pytest.param("int_key", "status", id="int_key"),
            pytest.param("metadata_list", "status", id="metadata_list")]
    return out


def refused(kind, where):
    if kind == "int_key":
        obj = with_value("x", where)
        obj["status"] = {1: "one"}
        return obj
    if kind == "metadata_list":
        obj = with_value("x", where)
        obj["metadata"] = ["a"]
        return obj
    return with_value(REFUSED[kind], where)


@pytest.mark.parametrize("kind,where", refused_objects())
def test_objects_not_json_standard_are_refused(native, kind, where):
    regions = regions_of(spec.load_cell(CELL).config)["Pod"]
    assert native.keys(native.compile_trie(regions.trie, ITER), refused(kind, where)) is None


def test_refusals_deep_and_long(native):
    cap = native.compile_trie({}, ITER)
    deep = {"spec": []}
    for _ in range(400):
        deep = {"spec": [deep]}
    assert native.keys(cap, deep) is None  # nesting past the pass's depth
    assert native.keys(cap, {"spec": 10**5000}) is None  # past the int's digit limit
    assert native.keys(cap, [1]) is None and native.keys(cap, "x") is None
    with pytest.raises(TypeError):
        native.compile_trie({1: None}, ITER)


@pytest.fixture
def armed():
    prev = telemetry.set_enabled(True)
    simmod._C_ADMIT_KEYS.clear()
    yield
    simmod._C_ADMIT_KEYS.clear()
    telemetry.set_enabled(prev)


def pod_sims(monkeypatch, capacity=64):
    cfg = spec.load_cell(CELL).config
    stages = stage_list(cfg["pod_stages"])
    native = DeviceSimulator(stages, capacity=capacity, seed=7, device="cpu")
    monkeypatch.setenv("KWOK_TPU_NATIVE", "0")
    plain = DeviceSimulator(stages, capacity=capacity, seed=7, device="cpu")
    monkeypatch.delenv("KWOK_TPU_NATIVE")
    assert plain._native_keys is None
    return native, plain


COLUMNS = ("sig", "behaviour", "ovc", "features", "del_ts", "stage", "fire_at", "active", "rematch")


def assert_same(a, b):
    for f in COLUMNS:
        assert np.array_equal(getattr(a, f), getattr(b, f)), f
    ba, bb = a.cset.behaviours, b.cset.behaviours
    assert ba.sig_table == bb.sig_table and ba.card == bb.card
    assert a.cset.version == b.cset.version and a.cset._sig_ids == b.cset._sig_ids
    assert a.objects == b.objects
    pa, _ = a.to_device()
    pb, _ = b.to_device()
    for f in pa._fields:
        assert np.array_equal(np.asarray(getattr(pa, f)), np.asarray(getattr(pb, f))), f


@pytest.mark.parametrize("seed", [1, SEED])
def test_simulators_with_and_without_the_pass_hold_the_same_rows(native, monkeypatch, armed,
                                                                 seed):
    _, _, pods = placed_cell(n_pods=3000, seed=seed)
    sim, plain = pod_sims(monkeypatch, capacity=4096)
    assert sim._native_keys is not None
    for obj in pods:
        assert sim.admit(obj) == plain.admit(obj)
    assert len(set(sim.sig[:3000].tolist())) == 3000
    assert_same(sim, plain)
    assert simmod._C_ADMIT_KEYS.snapshot() == {("Pod", "native"): 3000, ("Pod", "plain"): 3000}
    # an external change to one row: a label the regions read and a new spec
    for s in (sim, plain):
        obj = dict(s.objects[5])
        obj["metadata"] = dict(obj["metadata"], labels={
            "pod-container-running-failed.stage.kwok.x-k8s.io": "true"})
        obj["spec"] = dict(obj["spec"], initContainers=[{"name": "i", "image": "img"}])
        s.objects[5] = obj
        s.refresh_row(5)
        s.request_delete(9, 1234)
    assert_same(sim, plain)
    assert simmod._C_ADMIT_KEYS.snapshot() == {("Pod", "native"): 3002, ("Pod", "plain"): 3002}


@pytest.mark.parametrize("kind,where", [("datetime", "label"), ("date", "status"), ("tuple", "spec"),
                                        ("str_subclass", "label"), ("numpy_scalar", "spec"),
                                        ("int_key", "status")])
def test_a_refused_object_takes_the_python_path(native, monkeypatch, armed, kind, where):
    sim, plain = pod_sims(monkeypatch)
    obj = refused(kind, where)
    assert sim.admit(obj) == plain.admit(obj) == 0
    assert simmod._C_ADMIT_KEYS.snapshot() == {("Pod", "plain"): 2}
    sim.admit_bulk(obj, 3)
    plain.admit_bulk(obj, 3)
    assert simmod._C_ADMIT_KEYS.snapshot() == {("Pod", "plain"): 4}
    # what is stored is what the JSON-standard walk made of it; a refresh
    # takes the pass where that is standard
    stored = sim.objects[0]
    sim.refresh_row(0)
    plain.refresh_row(0)
    assert_same(sim, plain)
    cap = native.compile_trie(sim._regions.trie, ITER)
    if native.keys(cap, stored) is None:
        assert kind in ("str_subclass", "int_key")  # left as they are by the walk
        assert simmod._C_ADMIT_KEYS.snapshot() == {("Pod", "plain"): 6}
    else:
        assert stored is not obj and json.loads(json.dumps(stored)) == stored
        assert simmod._C_ADMIT_KEYS.snapshot() == {("Pod", "plain"): 5, ("Pod", "native"): 1}


def test_an_accepted_object_is_stored_as_admitted(native, monkeypatch, armed):
    sim, _ = pod_sims(monkeypatch)
    _, _, pods = placed_cell(n_pods=4)
    sim.admit(pods[0])
    sim.admit_bulk(pods[1], 2)
    assert sim.objects[0] is pods[0] and sim.objects[1] is pods[1] is sim.objects[2]
    assert simmod._C_ADMIT_KEYS.snapshot() == {("Pod", "native"): 2}


def test_a_set_without_a_regions_key_takes_the_python_path():
    class NoRegions:
        trie = None

    assert simmod._native_keys(NoRegions()) is None


def test_counter_is_served_with_the_phases_and_stops_with_telemetry(native, monkeypatch, armed):
    sim, plain = pod_sims(monkeypatch)
    _, nodes, pods = placed_cell(n_pods=8, n_nodes=2)
    for obj in pods[:5]:
        sim.admit(obj)
    plain.admit(pods[5])
    text = telemetry.registry().expose()
    assert "# TYPE kwok_sim_admit_keys_total counter" in text
    assert "kwok_sim_phase_seconds" in text
    samples = {(labels["kind"], labels["path"]): value for name, labels, value in
               promtext.iter_samples(text) if name == "kwok_sim_admit_keys_total"}
    assert samples == {("Pod", "native"): 5.0, ("Pod", "plain"): 1.0}
    telemetry.set_enabled(False)
    sim.admit(pods[6])
    assert simmod._C_ADMIT_KEYS.snapshot() == {("Pod", "native"): 5, ("Pod", "plain"): 1}


def test_counter_keeps_whole_counts_past_a_million(armed):
    for _ in range(3):
        simmod._C_ADMIT_KEYS.inc("Pod", "native")
    simmod._C_ADMIT_KEYS._values[("Pod", "native")] += 1_234_564
    assert 'kwok_sim_admit_keys_total{kind="Pod",path="native"} 1234567' in (
        telemetry.registry().expose())


SHARE = "setup.admit_native_share"


@pytest.mark.parametrize("text,share", [
    ('kwok_sim_admit_keys_total{kind="Pod",path="native"} 1000000\n'
     'kwok_sim_admit_keys_total{kind="Node",path="native"} 10000\n', 100.0),
    ('kwok_sim_admit_keys_total{kind="Pod",path="native"} 3\n'
     'kwok_sim_admit_keys_total{kind="Pod",path="plain"} 1\n', 75.0),
    ('kwok_sim_admit_keys_total{kind="Node",path="plain"} 10\n', 0.0),
    ('kwok_sim_phase_seconds_sum{kind="Pod",phase="admit"} 1.5\n', None),
    ("", None),
])
def test_native_share_reader(monkeypatch, text, share):
    read = spec.load_reader(spec.HERE, SHARE)
    monkeypatch.setattr(simphase, "exposition", lambda: text)
    assert read({}) == share


def test_native_share_reads_the_process_exposition(native, monkeypatch, armed):
    sim, plain = pod_sims(monkeypatch)
    _, _, pods = placed_cell(n_pods=4)
    for obj in pods[:3]:
        sim.admit(obj)
    plain.admit(pods[3])
    assert spec.load_reader(spec.HERE, SHARE)({}) == pytest.approx(75.0)


def test_the_benchmark_lists_the_share_for_the_placed_cell():
    with open(f"{spec.ROOT}/BENCHMARK.json") as f:
        entries = {m["name"]: m for m in json.load(f)["per_layer"]}
    assert entries[SHARE] == {"name": SHARE, "unit": "%", "better": "higher",
                              "source": "host_clock", "layer": "setup", "moves": "setup_s",
                              "workloads": [CELL]}
    assert SHARE in spec.load_cell(CELL).readers
    assert SHARE not in spec.load_cell("chaos-10k.sim").readers


def test_floats_are_python_reprs(native):
    cap = native.compile_trie({"spec": None}, ITER)
    rng = random.Random(SEED)
    for _ in range(2000):
        x = rng.choice([rng.random() * 10 ** rng.randint(-30, 30), rng.getrandbits(64) * 1.0,
                        -rng.random() * 1e-310])
        assert native.keys(cap, {"spec": x}) == (signature_text({"spec": x}),
                                                 json.dumps({"spec": x}))
