"""The port stands alone: no module of ``repro_torch`` (nor
``chip_smoke.py``) loads ``jax`` or anything of the JAX package ``repro``,
and the entry points never fall back to the CPU unasked."""

import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]

_PROBE = r"""
import importlib, pkgutil, sys
sys.path.insert(0, {src!r})
sys.path.insert(0, {root!r})
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                "repro_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib"))
             or m == "repro" or m.startswith("repro."))
print(len(names), bad)
"""


def test_no_module_of_the_port_loads_jax_or_repro():
    code = _PROBE.format(src=str(ROOT / "src"), root=str(ROOT))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, env=env, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr
    n, bad = out.stdout.strip().split(" ", 1)
    assert int(n) >= 20, out.stdout
    assert bad == "[]", f"loaded: {bad}"


def test_entry_points_need_a_device_or_the_card():
    import repro_torch.core as C
    from repro_torch.configs.sim import tiny_cluster

    if torch.cuda.is_available():
        st = C.build_statics(tiny_cluster())
        assert st.capacity.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            C.build_statics(tiny_cluster())
    st = C.build_statics(tiny_cluster(), device="cpu")
    s = C.init_state(tiny_cluster(), st, 0)
    assert s.free.device.type == "cpu" and s.t.device.type == "cpu"


def test_chip_smoke_fails_without_a_card_or_outside_a_checkout(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checks the no-card exit; the card runs chip_smoke.py")
    for cwd, script in ((ROOT, ROOT / "chip_smoke.py"),
                        (tmp_path, tmp_path / "chip_smoke.py")):
        if cwd == tmp_path:
            script.write_text((ROOT / "chip_smoke.py").read_text())
        out = subprocess.run([sys.executable, str(script)], cwd=str(cwd),
                             capture_output=True, text=True, timeout=120)
        assert out.returncode != 0
        assert '"ok": true' not in out.stdout
