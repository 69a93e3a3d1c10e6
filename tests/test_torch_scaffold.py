"""The port stands alone: ``import repro_torch`` pulls in neither JAX nor
the JAX package, no port source (nor ``chip_smoke.py``) imports them, and
a session without an explicit device needs a card."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import jax  # noqa: F401  (both frameworks load in the test process)
import pytest
import torch

import repro_torch
from repro_torch.core import Session
from repro_torch.device import resolve_device

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def _port_files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def test_import_leaves_jax_out():
    code = ("import sys, repro_torch, repro_torch.core, repro_torch.plan, "
            "repro_torch.kernels.ops, repro_torch.obs, "
            "repro_torch.core.calibrate, repro_torch.serve.engine, "
            "repro_torch.serve.workload, repro_torch.launch.serve, "
            "repro_torch.runtime.elastic, repro_torch.quickstart, "
            "repro_torch.kernels.autotune, repro_torch.obs.demo, "
            "repro_torch.collaborative_filtering, repro_torch.configs, "
            "repro_torch.configs.base, repro_torch.models.module, "
            "repro_torch.models.layers, repro_torch.models.mlp, "
            "repro_torch.models.attention, repro_torch.models.moe, "
            "repro_torch.models.mamba, repro_torch.models.rwkv, "
            "repro_torch.models.lm, repro_torch.models.encdec, "
            "repro_torch.models.api, repro_torch.sharding.ctx, "
            "repro_torch.serve.step; "
            "from repro_torch.configs import all_configs; all_configs(); "
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'repro' or m.startswith('repro.')); "
            "print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_source_imports_jax_or_repro(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), f"{path}: {mod}"


def test_package_has_the_reference_layout():
    for sub in ("core", "plan", "kernels", "obs"):
        assert (PORT / sub / "__init__.py").exists()
    assert (PORT / "core" / "joins_device.py").exists()
    for path in ("runtime/faults.py", "runtime/fault_tolerance.py",
                 "runtime/straggler.py", "runtime/elastic.py",
                 "obs/metrics.py", "obs/ledger.py", "core/calibrate.py",
                 "serve/engine.py", "serve/workload.py", "launch/serve.py",
                 "kernels/autotune.py", "obs/demo.py", "configs/__init__.py",
                 "configs/base.py", "models/module.py", "models/layers.py",
                 "models/mlp.py", "models/attention.py", "models/moe.py",
                 "models/mamba.py", "models/rwkv.py", "models/lm.py",
                 "models/encdec.py", "models/api.py", "sharding/ctx.py",
                 "serve/step.py"):
        assert (PORT / path).exists(), path
        assert (ROOT / "src" / "repro" / path).exists(), path
    for ref in (ROOT / "src" / "repro" / "configs").glob("*.py"):
        assert (PORT / "configs" / ref.name).exists(), ref.name
    assert repro_torch.resolve_device is resolve_device


def test_session_without_device_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Session()
    with pytest.raises(RuntimeError):
        Session(device="cuda")
    assert Session(device="cpu").device.type == "cpu"


def test_unported_session_options_raise(monkeypatch):
    from repro_torch.launch import serve
    # the LM path (--arch) is ported: without a card it raises rather than
    # running on the CPU (tests/test_torch_serve_step.py runs it there)
    with monkeypatch.context() as m:
        m.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            serve.main(["--arch", "qwen3-1.7b"])
    # multi-worker sessions and --measure-comm are ported: a two-worker
    # mesh on the session's device, and a launcher run that records bytes
    s2 = Session(device="cpu", n_workers=2)
    assert s2.workers == 2 and s2.mesh.n == 2
    assert s2.mesh.device == torch.device("cpu")
    assert serve.main(["--relational", "--device", "cpu", "--measure-comm",
                       "--clients", "20", "--dim", "16"]) == 0
    # the ledger and the calibrated cost model are ported
    s = Session(device="cpu", ledger=object(), cost_model=None)
    assert s.ledger is not None and s.cost_model is None


def test_chip_smoke_without_a_card_fails_and_prints_no_result(monkeypatch,
                                                              capsys):
    import importlib.util
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as exc:
        smoke.main([])
    assert exc.value.code not in (0, None)   # a message: exit status 1
    assert '"ok"' not in capsys.readouterr().out
