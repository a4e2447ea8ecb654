"""The port stands alone: no module of ``repro_torch`` (nor ``chip_smoke.py``
or a script under ``tools/``) imports JAX or anything of the JAX package ``repro``, and importing every
module of the port loads neither."""
import ast
import os
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"] + sorted((ROOT / "tools").glob("*.py"))


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_no_jax_or_repro_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        bad = [n for n in names if _forbidden(n)]
        assert not bad, f"{path.name}:{node.lineno} imports {bad}"


def test_importing_the_port_loads_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(k for k in sys.modules\n"
        "             if k.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "print(len([k for k in sys.modules if k.startswith('repro_torch')]))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip()) >= 25


def test_every_new_module_is_covered():
    """The modules of the staged route, of the tier plans, of LM serving
    (dense and ssm), of the store and incremental analytics, of graph
    serving, of checkpointing and resilience, of observability, of the
    multi-device backend (its graph and LM halves), of the sentinel (with
    its tool) and of training (the optimizer, the data stream and the
    train launcher, with its tool) are among the files checked above."""
    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    for mod in ("core/messages.py", "core/subgraph.py", "kernels/flat.py",
                "kernels/outbox_compact.py", "core/tiers.py",
                "core/blocks.py", "kernels/megastep.py", "configs/base.py",
                "models/layers.py", "models/transformer.py",
                "models/convert.py", "models/model.py", "models/ssm.py",
                "kernels/flash_attention.py", "kernels/mamba_scan.py",
                "training/train_step.py", "launch/serve.py",
                "gofs/store.py", "gofs/temporal.py",
                "algorithms/incremental.py", "serving/batched.py",
                "serving/planner.py", "serving/cache.py",
                "serving/service.py", "resilience/degrade.py",
                "resilience/faults.py", "training/checkpoint.py",
                "obs/skew.py", "resilience/recovery.py",
                "resilience/failover.py", "resilience/balance.py",
                "launch/elastic.py", "launch/chaos.py", "obs/trace.py",
                "obs/metrics.py", "launch/scope.py", "launch/mesh.py",
                "models/sharding.py", "training/shardspec.py",
                "core/wire.py", "analysis/__init__.py", "analysis/report.py",
                "analysis/semiring.py", "analysis/collectives.py",
                "analysis/kernel_lint.py", "launch/sentinel.py",
                "training/optimizer.py", "training/data.py",
                "launch/train.py"):
        assert f"src/repro_torch/{mod}" in names, mod
    assert "tools/sentinel_phase.py" in names
    assert "tools/training_phase.py" in names
