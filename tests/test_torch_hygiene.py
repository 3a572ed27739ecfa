"""The port stands alone: torchstore_tpu_torch and chip_smoke.py import
neither JAX nor anything of the JAX package torchstore_tpu."""

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN_ROOTS = {"jax", "jaxlib", "flax", "optax", "ml_dtypes", "torchstore_tpu"}


def port_sources() -> list[Path]:
    """The port, its smoke script, and the module its spawned test ranks
    import."""
    return sorted((ROOT / "torchstore_tpu_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py",
        ROOT / "tests" / "test_torch_sp_worker.py",
    ]


def forbidden_imports(path: Path) -> list[str]:
    tree = ast.parse(path.read_text(), filename=str(path))
    found = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [alias.name for alias in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names = [node.module]
        else:
            continue
        found += [n for n in names if n.split(".")[0] in FORBIDDEN_ROOTS]
    return found


@pytest.mark.parametrize("path", port_sources(), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_reference_or_jax_import_in_source(path):
    assert forbidden_imports(path) == []


def test_ast_scan_catches_a_forbidden_import(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text("import jax.numpy as jnp\nfrom torchstore_tpu.utils import Box\n"
                   "from torchstore_tpu_torch.utils import Box as B\n")
    assert forbidden_imports(bad) == ["jax.numpy", "torchstore_tpu.utils"]


def test_import_leaves_no_jax_or_reference_module():
    code = (
        "import json, sys\n"
        "import torchstore_tpu_torch, torchstore_tpu_torch.direct_weight_sync\n"
        "import torchstore_tpu_torch.workloads, torchstore_tpu_torch.parallel\n"
        "import torchstore_tpu_torch.ops.flash_attention, torchstore_tpu_torch.ops.ring_attention\n"
        "import torchstore_tpu_torch.ops._sharded, torchstore_tpu_torch.ops.ulysses_attention\n"
        "import torchstore_tpu_torch.models.llama, torchstore_tpu_torch.models.generate\n"
        "import torchstore_tpu_torch.weight_channel, torchstore_tpu_torch.stream_sync\n"
        "import torchstore_tpu_torch.examples.torchstore_rl\n"
        "import torchstore_tpu_torch.transport.device_transfer, torchstore_tpu_torch.provision.pool\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{sorted(FORBIDDEN_ROOTS)!r})\n"
        "print(json.dumps(bad))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120
    )
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
