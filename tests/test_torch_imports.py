"""Import hygiene: the port and chip_smoke.py stand alone.

Every module of ``islam_tpu_torch`` is imported in a fresh interpreter, after
which neither ``jax`` nor ``islam_tpu`` may be in ``sys.modules`` and nothing
may have been compiled.  ``chip_smoke.py`` must not name either package in an
import.
"""

import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "islam_tpu_torch"


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
            "islam_tpu_torch.utils.checkpoints"} <= set(mods)
    code = "\n".join(
        ["import importlib, sys"]
        + [f"importlib.import_module({m!r})" for m in mods]
        + ["bad = sorted(m for m in sys.modules if m == 'jax' "
           "or m.startswith('jax.') or m == 'islam_tpu' "
           "or m.startswith('islam_tpu.'))",
           "assert not bad, bad",
           "from islam_tpu_torch.ops import correlation as c",
           "assert c._fns == {} and c.LAUNCHES == c.LAUNCHES_ALL == 0",
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
        assert m != "jax" and not m.startswith("jax.")
        assert m != "islam_tpu" and not m.startswith("islam_tpu.")
    assert "import jax" not in src and "islam_tpu." not in src.replace(
        "islam_tpu_torch.", "")
