"""The port stands alone: it never imports JAX or the JAX package.

``tests/conftest.py`` imports jax into every test process, so the import
check runs in a fresh subprocess.
"""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((REPO / "globalign_tpu_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py"
]


def test_import_leaves_jax_out():
    code = (
        "import sys\n"
        "import globalign_tpu_torch, globalign_tpu_torch.cli\n"
        "import globalign_tpu_torch.utils.cuda_build\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'globalign_tpu', 'globalign'))\n"
        "assert not bad, bad\n"
        "assert 'torch' in sys.modules\n"
        "print('isolated')\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True,
        text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "isolated"


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: p.name)
def test_source_imports_no_jax(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "globalign_tpu", "globalign"), (
                path, node.lineno, name,
            )


def test_chip_smoke_refuses_to_run_without_a_gpu():
    """Without a CUDA device the smoke script exits non-zero, no result."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the script would run")
    proc = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=REPO, capture_output=True,
        text=True, timeout=300,
    )
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    assert "no CUDA device" in proc.stderr


def test_chip_smoke_refuses_to_run_alone(tmp_path):
    """Copied away from the package, the smoke script exits non-zero and
    prints no result line."""
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((REPO / "chip_smoke.py").read_text())
    proc = subprocess.run(
        [sys.executable, str(alone)], cwd=tmp_path, capture_output=True,
        text=True, timeout=300,
    )
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
