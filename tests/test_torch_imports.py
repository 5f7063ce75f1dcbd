"""Import hygiene: the port and chip_smoke.py stand alone.

Every module of ``islam_tpu_torch`` is imported in a fresh interpreter, after
which none of ``jax``, ``islam_tpu``, ``cv2``, ``PIL``, ``yaml``, ``pandas``,
``pykitti``, ``orbax``, ``flax`` or ``optax`` may be in ``sys.modules`` and
nothing may have been
compiled or loaded.  Neither the port's sources nor ``chip_smoke.py`` may
name one of them in an import.
"""

import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "islam_tpu_torch"
# top-level packages the port and chip_smoke.py must not import: JAX, the
# JAX package, and the libraries the card's machine does not have
FORBIDDEN = {"jax", "islam_tpu", "cv2", "PIL", "yaml", "pandas", "pykitti",
             "orbax", "flax", "optax"}


def _modules():
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(ROOT).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield ".".join(parts)


def test_port_imports_neither_jax_nor_islam_tpu():
    mods = list(_modules())
    assert "islam_tpu_torch.train" in mods and len(mods) > 20
    assert {"islam_tpu_torch.optim", "islam_tpu_torch.bench_corr",
            "islam_tpu_torch.imu.denoiser",
            "islam_tpu_torch.utils.checkpoints",
            "islam_tpu_torch.data.image_io", "islam_tpu_torch.data.loaders",
            "islam_tpu_torch.data.native",
            "islam_tpu_torch.evaluate", "islam_tpu_torch.ops.dense_ba",
            "islam_tpu_torch.ops.sift",
            "islam_tpu_torch.imu.bias", "islam_tpu_torch.models.psmnet",
            "islam_tpu_torch.utils.visualization",
            "islam_tpu_torch.parallel.mesh", "islam_tpu_torch.parallel.trainer",
            "islam_tpu_torch.testing",
            "islam_tpu_torch.validate_multihost",
            "islam_tpu_torch.pvgo.pypose_replica",
            "islam_tpu_torch.demo_imperative",
            "islam_tpu_torch.utils.jax_state",
            "islam_tpu_torch.tools.h100", "islam_tpu_torch.tools.flops",
            "islam_tpu_torch.tools.window",
            "islam_tpu_torch.tools.conv_roofline",
            "islam_tpu_torch.tools.copies"} <= set(mods)
    code = "\n".join(
        ["import importlib, sys"]
        + [f"importlib.import_module({m!r})" for m in mods]
        + [f"bad = sorted(m for m in sys.modules if m.split('.')[0] in "
           f"{sorted(FORBIDDEN)!r})",
           "assert not bad, bad",
           "from islam_tpu_torch.ops import correlation as c",
           "assert c._fns == {} and c.LAUNCHES == c.LAUNCHES_ALL == 0",
           "from islam_tpu_torch.data import native",
           "assert native._LIB is None",
           "print('ok')"])
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def test_chip_smoke_imports_neither_jax_nor_islam_tpu():
    src = (ROOT / "chip_smoke.py").read_text()
    imports = re.findall(r"^\s*(?:from|import)\s+([\w.]+)", src, re.M)
    assert "islam_tpu_torch.train" in imports or any(
        m.startswith("islam_tpu_torch") for m in imports)
    for m in imports:
        assert m.split(".")[0] not in FORBIDDEN, m
    assert "import jax" not in src and "islam_tpu." not in src.replace(
        "islam_tpu_torch.", "")


def test_port_names_no_forbidden_package_in_an_import():
    """No import line of the port's sources names an image, YAML, table or
    checkpoint library that the card's machine lacks (nor JAX), even in a
    function that the module import above does not run."""
    for path in sorted(PKG.rglob("*.py")):
        src = path.read_text()
        for m in re.findall(r"^\s*(?:from|import)\s+([\w.]+)", src, re.M):
            assert m.split(".")[0] not in FORBIDDEN, (path, m)
