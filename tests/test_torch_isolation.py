"""kwok_tpu_torch stands alone and never hides the device.

- It imports neither jax nor anything of kwok_tpu (proved in a fresh
  interpreter where importing jax fails), and its sources do not name
  them.
- Its entry points run on the card unless the caller passes
  device="cpu": without CUDA they raise instead of running on the CPU.
- The kernel wrappers take the plain version only for CPU tensors.
- On a machine with a card, the CUDA kernels equal their plain versions
  (the same check chip_smoke.py makes at full size).
"""

import re
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from kwok_tpu_torch.engine.simulator import DeviceSimulator
from kwok_tpu_torch.ops import prng
from kwok_tpu_torch.ops import tick as tt
from kwok_tpu_torch.stages import load_builtin

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted(
    p for p in (ROOT / "kwok_tpu_torch").rglob("*")
    if p.suffix in (".py", ".cu", ".cuh") and "_build" not in p.parts
) + [ROOT / "chip_smoke.py"]


def test_imports_without_jax_or_kwok_tpu():
    code = textwrap.dedent(
        """
        import importlib, pkgutil, sys
        sys.modules["jax"] = None  # any import of jax now raises
        import kwok_tpu_torch
        names = [m.name for m in pkgutil.walk_packages(kwok_tpu_torch.__path__, "kwok_tpu_torch.")]
        for name in names:
            importlib.import_module(name)
        import chip_smoke
        leaked = sorted(m for m, mod in sys.modules.items() if mod is not None and (
            m in ("kwok_tpu", "jax") or m.startswith(("kwok_tpu.", "jax."))))
        print(len(names), leaked)
        assert not leaked, leaked
        """
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=300
    )
    assert out.returncode == 0, out.stderr
    # every module of the package was imported (all but the top __init__)
    py_files = [p for p in PORT_FILES if p.suffix == ".py" and p.name != "chip_smoke.py"]
    assert int(out.stdout.split()[0]) == len(py_files) - 1


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_sources_do_not_name_jax_or_kwok_tpu(path):
    text = path.read_text()
    assert not re.search(r"^\s*(import jax|from jax)\b", text, re.M)
    assert not re.search(r"\bkwok_tpu\.", text), "names a module of kwok_tpu"


def test_entry_points_raise_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: nothing to refuse")
    with pytest.raises(RuntimeError, match="CUDA"):
        DeviceSimulator(load_builtin("pod-fast"), capacity=4)
    with pytest.raises(RuntimeError, match="CUDA"):
        tt.resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA"):
        prng.prng_key(0)


def test_wrappers_refuse_devices_without_kernel_or_plain_version():
    sim = DeviceSimulator(load_builtin("pod-fast"), capacity=4, device="cpu")
    params, soa = sim.to_device()
    meta = tt.SoA(*(t.to("meta") for t in soa))
    with pytest.raises(ValueError, match="meta"):
        tt.tick(params, meta, 100)
    with pytest.raises(ValueError, match="meta"):
        tt.run_ticks_collect(params, meta, 100, 8)


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    sim = DeviceSimulator(load_builtin("pod-fast"), capacity=4, device="cpu")
    sim.admit({"metadata": {"name": "p", "namespace": "d"}, "spec": {"nodeName": "n"}})
    tt.reset_launches()
    sim.tick_many(100, 8)
    sim.step(100)
    assert tt.launches() == {"tick": 0, "run_ticks_collect": 0, "run_ticks": 0, "scatter_rows": 0}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py makes this check on the card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_kernels_equal_plain_versions_on_the_card(cuda_device):
    from kwok_tpu_torch.engine.compiler import CompiledStageSet

    stages = load_builtin("pod-general") + load_builtin("pod-chaos")
    cset = CompiledStageSet(stages)
    cset.signature_for({"metadata": {"name": "p"}, "spec": {"nodeName": "n"}})
    params = tt.params_from_compiled(cset, cuda_device)
    rng = np.random.default_rng(0)
    n = 5003
    soa = tt.soa_from_numpy(dict(
        features=rng.integers(0, 8, (n, cset.C)).astype(np.int32),
        sig=np.zeros(n, np.int32), ovc=np.zeros(n, np.int32),
        stage=rng.integers(-1, cset.num_stages, n).astype(np.int32),
        fire_at=rng.integers(0, 3000, n).astype(np.int32),
        active=rng.random(n) < 0.9, rematch=rng.random(n) < 0.5,
        del_ts=np.full(n, -(2**31), np.int32),
        now=np.array(0, np.int32), key=np.array([0, 3], np.uint32)), cuda_device)
    ks = tt.SoA(*(t.clone() for t in soa))
    ps = tt.SoA(*(t.clone() for t in soa))
    ks, kst = tt.run_ticks_collect(params, ks, 100, 8)
    ps, pst = tt._run_ticks_collect_impl(params, ps, 100, 8)
    assert torch.equal(kst, pst)
    for f in ("features", "stage", "fire_at", "active", "rematch", "now"):
        assert torch.equal(getattr(ks, f), getattr(ps, f)), f
    assert torch.equal(ks.key.view(torch.int32), ps.key.view(torch.int32))
