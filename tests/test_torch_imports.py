"""Import discipline of the PyTorch port: no module of ``repro_torch``
(nor ``chip_smoke.py``, nor an example of ``examples_torch/``) pulls in
``jax`` or the reference package ``repro``, and importing builds
nothing."""
import ast
import os
import pathlib
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"


def _modules():
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(PKG.parent).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield ".".join(parts)


def test_every_module_imports_without_jax_or_reference():
    mods = list(_modules())
    assert len(mods) > 30
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "from repro_torch.kernels import cuda\n"
        "assert cuda._LIB is None      # nothing built at import\n"
        "print('ok', len(sys.modules))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py")) +
                         [ROOT / "chip_smoke.py"] +
                         sorted((ROOT / "examples_torch").glob("*.py")),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_source_names_jax_or_reference(path):
    """Static check, so a lazily imported module cannot slip through."""
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in ("jax", "jaxlib", "repro"), \
                f"{path}: imports {name}"


def test_server_without_cuda_raises_named_error(monkeypatch):
    from repro_torch.models.frontends import CudaUnavailableError
    from repro_torch.runtime.server import AdaptiveServer
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(CudaUnavailableError, match='device="cpu"'):
        AdaptiveServer()


def test_kernel_launch_refuses_cpu_tensors():
    """The launch path checks its operands before touching the card."""
    from repro_torch.kernels import cuda
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        cuda.require(torch.zeros(3), "x")


def test_chip_smoke_refuses_to_run_without_a_card(tmp_path):
    """Without CUDA — or alone in a directory, without the package — the
    smoke script exits non-zero and prints no result."""
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((ROOT / "chip_smoke.py").read_text())
    scripts = [alone]
    if not torch.cuda.is_available():     # with a card it would run
        scripts.append(ROOT / "chip_smoke.py")
    for script in scripts:
        out = subprocess.run([sys.executable, str(script)],
                             cwd=script.parent, capture_output=True,
                             text=True, timeout=300)
        assert out.returncode != 0
        assert '"ok"' not in out.stdout
