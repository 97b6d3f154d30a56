"""The port imports neither JAX nor dojo_tpu: in a fresh interpreter where
``import jax`` fails, every module of dojo_tpu_torch imports, and so does
chip_smoke (as a module, not run)."""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PROBE = r"""
import pkgutil, sys
sys.modules["jax"] = None  # any `import jax` now raises ImportError
sys.path.insert(0, sys.argv[1])
import dojo_tpu_torch
names = [m.name for m in pkgutil.walk_packages(dojo_tpu_torch.__path__, "dojo_tpu_torch.")]
for name in names:
    __import__(name)
import chip_smoke
bad = sorted(m for m, mod in sys.modules.items()
             if mod is not None and (m == "dojo_tpu" or m.startswith(("dojo_tpu.", "jax"))))
print(len(names), bad)
"""


def test_port_imports_without_jax():
    out = subprocess.run(
        [sys.executable, "-c", PROBE, ROOT], capture_output=True, text=True, timeout=120,
        env={**os.environ, "PYTHONPATH": ""},
    )
    assert out.returncode == 0, out.stderr
    n, bad = out.stdout.strip().split(" ", 1)
    assert int(n) >= 17  # every module of the package was imported
    assert bad == "[]", f"loaded {bad}"


def test_port_sources_name_no_jax():
    """No source of the port (or chip_smoke.py) imports jax or dojo_tpu."""
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, fs in os.walk(os.path.join(ROOT, "dojo_tpu_torch")):
        files += [os.path.join(d, f) for f in fs if f.endswith(".py")]
    for path in files:
        with open(path) as f:
            for line in f:
                s = line.strip()
                assert not s.startswith(("import jax", "from jax", "import dojo_tpu ",
                                         "from dojo_tpu ", "from dojo_tpu.")), f"{path}: {s}"


def test_port_assets_are_dojo_tpu_urdfs():
    """The port's assets are URDFs copied from dojo_tpu/assets unchanged
    (the thirteen its models load), its models read them from its own
    directory, and no mesh file is copied: a mesh stays a file name
    (visuals only)."""
    port = os.path.join(ROOT, "dojo_tpu_torch", "assets")
    names = sorted(os.listdir(port))
    assert names == sorted([
        "ant.urdf", "atlas_simple.urdf", "fourbar.urdf", "gazebo_a1.urdf", "halfcheetah.urdf",
        "hopper.urdf", "humanoid.urdf", "mini_tortuga_fixed_rotors.urdf", "model.urdf",
        "panda_end_effector.urdf", "pelican_fixed_rotors.urdf", "walker.urdf", "youbot.urdf"])
    for name in names:
        with open(os.path.join(port, name), "rb") as f, \
                open(os.path.join(ROOT, "dojo_tpu", "assets", name), "rb") as g:
            assert f.read() == g.read(), name
    from dojo_tpu_torch.models import locomotion, misc

    assert locomotion.ASSETS == misc.ASSETS and os.path.samefile(misc.ASSETS, port)
