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
PORT_FILES = sorted((REPO / "globalign_tpu_torch").rglob("*.py"))


def test_import_leaves_jax_out():
    code = (
        "import sys\n"
        "import globalign_tpu_torch, globalign_tpu_torch.cli\n"
        "import globalign_tpu_torch.utils.cuda_build\n"
        "import globalign_tpu_torch.batch, globalign_tpu_torch.runner\n"
        "import globalign_tpu_torch.batch_cli\n"
        "import globalign_tpu_torch.parallel.multihost\n"
        "import globalign_tpu_torch.parallel, globalign_tpu_torch.parallel.seqpar\n"
        "import globalign_tpu_torch.ops.fill_batch\n"
        "import globalign_tpu_torch.ops.fill_wave\n"
        "import globalign_tpu_torch.compat, globalign_tpu_torch.compat.globaligner\n"
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

