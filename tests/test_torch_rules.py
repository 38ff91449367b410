"""Rules of the PyTorch port.

(a) No module of ``src/repro_torch`` and not ``chip_smoke.py`` imports
    ``jax``, ``jaxlib`` or the JAX package ``repro``.
(b) Importing the port's entry points loads neither ``jax`` nor ``repro``.
(c) The serving entry point and the quickstart default to the card and
    raise without one.
(d) A kernel call on a tensor that is not on the CPU builds or raises: with
    no ``nvcc`` it raises and never falls back to the plain version.  (A
    CPU-only PyTorch cannot make a CUDA tensor, so a ``meta`` tensor stands
    in for one: both take the kernel route.)
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch import kernels as TK
from repro_torch.kernels import _build

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "repro"}


def _port_files():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    return files


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax_and_no_reference(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        bad = [n for n in names if n.split(".")[0] in FORBIDDEN]
        assert not bad, f"{path.name}:{node.lineno} imports {bad}"


def test_entry_points_load_no_jax():
    code = ("import sys\n"
            "from repro_torch.launch.serve import serve_diffusion\n"
            "import repro_torch.convert, repro_torch.kernels, repro_torch.kernels.ops\n"
            "import repro_torch.quickstart\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')))\n")
    env = {"PATH": os.environ.get("PATH", "/usr/bin:/bin"), "PYTHONPATH": str(ROOT / "src"),
           "JAX_PLATFORMS": "cpu", "HOME": os.environ.get("HOME", "/tmp")}
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_serve_defaults_to_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    from repro_torch.launch.serve import serve_diffusion
    with pytest.raises(RuntimeError, match="CUDA"):
        serve_diffusion("flux-mmdit", num_requests=1, num_steps=1)


def test_quickstart_defaults_to_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    from repro_torch import quickstart
    with pytest.raises(RuntimeError, match="CUDA"):
        quickstart.main([])


def test_kernel_route_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_LIB", None)
    monkeypatch.setattr(_build, "find_nvcc", lambda: None)
    meta = lambda *s, dtype=torch.float32: torch.empty(s, dtype=dtype, device="meta")
    i32 = torch.int32
    calls = [
        lambda: TK.gemm_q_sparse_kernel(meta(2, 64, 32), meta(32, 32), meta(2, 2, dtype=i32),
                                        meta(2, dtype=i32), block_rows=32),
        lambda: TK.flashomni_attention_csr(
            meta(4, 64, 32), meta(4, 64, 32), meta(4, 64, 32), meta(4, 64, 32),
            meta(4, 4, dtype=i32), meta(4, 4, dtype=i32), meta(4, dtype=i32),
            meta(4, 4, 4, dtype=i32), meta(4, 4, dtype=i32), block_q=16, block_kv=16),
        lambda: TK.gemm_o_sparse_kernel(meta(2, 2, 64, 32), meta(2, 32, 32), meta(2, 64, 32),
                                        meta(2, 2, dtype=i32), meta(2, 2, 2, dtype=i32),
                                        meta(2, 2, dtype=i32), block_rows=32),
        lambda: TK.flashomni_attention_csr_bucketed(
            meta(4, 64, 32), meta(4, 64, 32), meta(4, 64, 32), meta(4, 64, 32),
            meta(2, 8, dtype=i32), meta(2, 8, dtype=i32), meta(2, 8, dtype=i32),
            meta(2, 24, dtype=i32), meta(2, 8, dtype=i32), ((2, 4), (6, 2)),
            heads=2, block_q=16, block_kv=16),
        lambda: TK.gemm_o_sparse_bucketed_kernel(
            meta(2, 2, 64, 32), meta(2, 32, 32), meta(2, 64, 32), meta(2, 2, dtype=i32),
            meta(2, 2, dtype=i32), meta(2, 3, dtype=i32), meta(2, 2, dtype=i32),
            ((1, 2), (1, 1)), block_rows=32),
        lambda: TK.flashomni_attention_symbols(
            meta(4, 64, 32), meta(4, 64, 32), meta(4, 64, 32), meta(4, 64, 32),
            meta(4, 1, dtype=torch.uint8), meta(4, 2, dtype=torch.uint8),
            block_q=16, block_kv=16),
        lambda: TK.taylor_reuse_kernel(meta(2, 4, 64, 32), meta(2), meta(4, 64, 32),
                                       meta(4, 4, dtype=i32), meta(4, dtype=i32), block=16),
    ]
    assert len(calls) == len(TK.KERNELS)
    before = [fn.launches for fn in TK.KERNELS]
    for call in calls:
        with pytest.raises(RuntimeError, match="nvcc not found"):
            call()
    assert [fn.launches for fn in TK.KERNELS] == before
    assert not (tmp_path / "build").exists()


def test_find_nvcc_honours_path_and_cuda_home(monkeypatch, tmp_path):
    if Path("/usr/local/cuda/bin/nvcc").is_file():
        pytest.skip("a CUDA toolkit is installed at the default root")
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    assert _build.find_nvcc() is None
    nvcc = tmp_path / "cuda" / "bin" / "nvcc"
    nvcc.parent.mkdir(parents=True)
    nvcc.write_text("#!/bin/sh\n")
    nvcc.chmod(0o755)
    assert _build.find_nvcc() == str(nvcc)
