"""No module the harness or the reference loads is JAX or the JAX
package (top-level names compared whole: ``kwok_tpu_torch`` is not
``kwok_tpu``), and the reference loads nothing of the program."""

import json
import os
import subprocess
import sys

from kwokbench import spec

BLOCKED = {"jax", "jaxlib", "flax", "kwok_tpu"}


def modules_of(prefixes):
    out = []
    for d, _, files in os.walk(spec.HERE):
        if "tests" in d.split(os.sep) or "site" in d.split(os.sep) or "__pycache__" in d:
            continue
        for f in files:
            if f.endswith(".py") and "." not in f[:-3]:
                rel = os.path.relpath(os.path.join(d, f[:-3]), spec.ROOT)
                mod = rel.replace(os.sep, ".").removesuffix(".__init__")
                if mod.startswith(prefixes):
                    out.append(mod)
    return sorted(out)


def loaded_top_level(modules, extra=""):
    code = (f"import importlib, json, sys\n{extra}\n"
            f"for m in {modules!r}: importlib.import_module(m)\n"
            "print(json.dumps(sorted({n.split('.')[0] for n in sys.modules})))")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT, env=env,
                         capture_output=True, text=True, timeout=300, check=True)
    return set(json.loads(out.stdout.splitlines()[-1]))


def test_harness_and_reference_load_neither_jax_nor_the_jax_package():
    mods = modules_of(("kwokbench",))
    assert "kwokbench.run" in mods and "kwokbench.reference.fsm" in mods
    # the drivers load the program as a run does
    loaded = loaded_top_level(mods, "import kwok_tpu_torch.engine.simulator, "
                                    "kwok_tpu_torch.cmd.kwokctl")
    assert "kwok_tpu_torch" in loaded
    assert not loaded & BLOCKED, loaded & BLOCKED


def test_reference_loads_nothing_of_the_program():
    loaded = loaded_top_level(modules_of(("kwokbench.reference",)))
    assert not loaded & (BLOCKED | {"kwok_tpu_torch"}), loaded


def test_metric_readers_load_nothing_of_the_program():
    readers = [f[:-3] for f in os.listdir(os.path.join(spec.HERE, "metrics")) if f.endswith(".py")]
    extra = ("from kwokbench import spec\n"
             f"for r in {readers!r}: spec.load_reader(spec.HERE, r)")
    loaded = loaded_top_level([], extra)
    assert not loaded & (BLOCKED | {"kwok_tpu_torch"}), loaded
