"""The port stands alone: no file of ``src/repro_torch`` or ``chip_smoke.py``
imports JAX or the JAX package, importing the engine loads neither, and
entry points asked for no device want the card."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "scripts" / "profile_torch_serve.py",
    ROOT / "scripts" / "profile_torch_train.py", ROOT / "scripts" / "flash_variants.py",
    ROOT / "scripts" / "bench_autotune_torch.py", ROOT / "scripts" / "roofline_report_torch.py"]


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "repro", "flax", "optax")


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_repro_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            if _forbidden(node.module):
                bad.append(node.module)
    assert not bad, f"{path}: {bad}"


def test_importing_the_port_loads_no_jax():
    code = ("import sys, repro_torch.serving.engine, repro_torch.launch.serve, "
            "repro_torch.bridge, repro_torch.launch.train, repro_torch.models.moe, "
            "repro_torch.content_key, "
            "repro_torch.training.checkpoint, repro_torch.data.pipeline, "
            "repro_torch.core.engines.local, repro_torch.core.autotune, "
            "repro_torch.core.api, repro_torch.examples.train_lm, "
            "repro_torch.examples.serve_lm, repro_torch.examples.automl_pipeline\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'repro'))\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   cwd=ROOT, timeout=120)


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    from repro_torch.configs import get_arch, reduced
    from repro_torch.models import transformer as T
    from repro_torch.serving.engine import ServingEngine
    cfg = reduced(get_arch("stablelm-1.6b").model)
    with pytest.raises(RuntimeError, match="cuda"):
        T.init_lm(cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        T.init_caches(cfg, 1, 8)
    with pytest.raises(RuntimeError, match="cuda"):
        ServingEngine(cfg, T.init_lm(cfg, device="cpu"))
