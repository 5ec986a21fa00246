"""zutis_tpu_torch stands alone: in a fresh interpreter where importing jax,
flax, PIL or zutis_tpu fails, the package and every submodule import."""
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]

_PROBE = r"""
import importlib, pkgutil, sys

BLOCKED = ("jax", "jaxlib", "flax", "optax", "PIL", "yaml", "zutis_tpu")


class Blocker:
    def find_spec(self, name, path=None, target=None):
        root = name.split(".")[0]
        if root in BLOCKED:
            raise ImportError(f"blocked import of {name}")
        return None


sys.meta_path.insert(0, Blocker())
import zutis_tpu_torch

names = [m.name for m in pkgutil.walk_packages(zutis_tpu_torch.__path__,
                                               "zutis_tpu_torch.")]
for name in names:
    importlib.import_module(name)
leaked = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
assert not leaked, leaked
print("imported", len(names))
"""


def _run(code):
    return subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)


def test_port_imports_without_jax_flax_pil_or_zutis_tpu():
    proc = _run(_PROBE)
    assert proc.returncode == 0, proc.stderr
    n = int(proc.stdout.split()[-1])
    assert n >= 15, proc.stdout


def test_blocker_really_blocks():
    proc = _run(_PROBE.replace("import zutis_tpu_torch\n",
                               "import zutis_tpu_torch\nimport zutis_tpu\n"))
    assert proc.returncode != 0
    assert "blocked import of zutis_tpu" in proc.stderr
