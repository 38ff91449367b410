"""Rules of the PyTorch port.

(a) No module of ``src/repro_torch`` and not ``chip_smoke.py`` imports
    ``jax``, ``jaxlib`` or the JAX package ``repro``.
(b) Importing the port's entry points loads neither ``jax`` nor ``repro``.
(c) The serving entry points (diffusion and LM) and the quickstart
    default to the card and raise without one (the training launcher's case is in
    ``tests/test_torch_train.py``).
(d) A kernel call on a CUDA tensor builds or raises: with no ``nvcc`` it
    raises and never falls back to the plain version.  (A CPU-only PyTorch
    cannot allocate a CUDA tensor, so a fake one, ``FakeTensorMode``'s
    ``device="cuda"``, stands in for one; a ``meta`` tensor takes the
    wrappers' shapes-only route, ``tests/test_torch_dryrun.py``.)
(e) The profile of ``chip_smoke.py`` sees every kernel: each ``__global__``
    function in ``csrc/*.cu`` falls into the group of the wrapper that
    launches it, never into "other".
(f) The attention kernels' input checks: a contiguous view whose data does
    not start on a 16-byte boundary is refused, and the walk is counted
    only on a CUDA device.
(g) The sparse GEMMs' staging path: 16-byte copies only where every row
    starts on a 16-byte boundary, and ``chip_smoke.py`` reads each built
    instance's registers and spills from the ``ptxas`` report.
"""

import ast
import importlib.util
import os
import re
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
            "import repro_torch.analysis.__main__, repro_torch.analysis.cost_passes\n"
            "import repro_torch.launch.train\n"
            "from repro_torch.launch.serve import serve_lm\n"
            "import repro_torch.models.transformer, repro_torch.models.registry\n"
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


def test_serve_lm_defaults_to_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    from repro_torch.launch.serve import serve_lm
    with pytest.raises(RuntimeError, match="CUDA"):
        serve_lm("gemma3-1b")


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
    from torch._subclasses.fake_tensor import FakeTensorMode
    card = lambda *s, dtype=torch.float32: torch.empty(s, dtype=dtype, device="cuda")
    i32 = torch.int32
    calls = [
        lambda: TK.gemm_q_sparse_kernel(card(2, 64, 32), card(32, 32), card(2, 2, dtype=i32),
                                        card(2, dtype=i32), block_rows=32),
        lambda: TK.flashomni_attention_csr(
            card(4, 64, 32), card(4, 64, 32), card(4, 64, 32), card(4, 64, 32),
            card(4, 4, dtype=i32), card(4, 4, dtype=i32), card(4, dtype=i32),
            card(4, 4, 4, dtype=i32), card(4, 4, dtype=i32), block_q=16, block_kv=16),
        lambda: TK.gemm_o_sparse_kernel(card(2, 2, 64, 32), card(2, 32, 32), card(2, 64, 32),
                                        card(2, 2, dtype=i32), card(2, 2, 2, dtype=i32),
                                        card(2, 2, dtype=i32), block_rows=32),
        lambda: TK.flashomni_attention_csr_bucketed(
            card(4, 64, 32), card(4, 64, 32), card(4, 64, 32), card(4, 64, 32),
            card(2, 8, dtype=i32), card(2, 8, dtype=i32), card(2, 8, dtype=i32),
            card(2, 24, dtype=i32), card(2, 8, dtype=i32), ((2, 4), (6, 2)),
            heads=2, block_q=16, block_kv=16),
        lambda: TK.gemm_o_sparse_bucketed_kernel(
            card(2, 2, 64, 32), card(2, 32, 32), card(2, 64, 32), card(2, 2, dtype=i32),
            card(2, 2, dtype=i32), card(2, 3, dtype=i32), card(2, 2, dtype=i32),
            ((1, 2), (1, 1)), block_rows=32),
        lambda: TK.flashomni_attention_symbols(
            card(4, 64, 32), card(4, 64, 32), card(4, 64, 32), card(4, 64, 32),
            card(4, 1, dtype=torch.uint8), card(4, 2, dtype=torch.uint8),
            block_q=16, block_kv=16),
        lambda: TK.taylor_reuse_kernel(card(2, 4, 64, 32), card(2), card(4, 64, 32),
                                       card(4, 4, dtype=i32), card(4, dtype=i32), block=16),
    ]
    assert len(calls) == len(TK.KERNELS)
    before = [fn.launches for fn in TK.KERNELS]
    for call in calls:
        with FakeTensorMode(), pytest.raises(RuntimeError, match="nvcc not found"):
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_check_aligned_refuses_an_offset_view(dtype):
    base = torch.zeros(4 * 64, dtype=dtype)
    _build.check_aligned("q", base)
    step = 16 // base.element_size()
    _build.check_aligned("q", base[step:])                  # 16 bytes in: aligned
    view = base[1:].view(5, 51)                             # contiguous, misaligned
    assert view.is_contiguous()
    with pytest.raises(ValueError, match="q: .*16-byte boundary"):
        _build.check_aligned("q", view)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cols,offset", [(128, 0), (104, 0), (100, 0), (128, 1)])
def test_gemm_staging_path_follows_rows_and_pointers(dtype, cols, offset):
    """16-byte staging needs data that starts on a 16-byte boundary and rows
    of a multiple of 16 bytes: 100 float32 are 400 bytes, 100 bfloat16 200."""
    base = torch.zeros(8 * cols + 8, dtype=dtype)
    t = base[offset:offset + 8 * cols].view(8, cols)
    want = offset == 0 and not (cols == 100 and dtype == torch.bfloat16)
    assert _build.aligned_rows((t, cols)) == want
    assert not _build.aligned_rows((t, cols), (base[1:9], 8))


def test_chip_smoke_reads_ptxas_usage(tmp_path, monkeypatch):
    smoke = _chip_smoke()
    lib = tmp_path / "libflashomni_0123456789abcdef.so"
    (tmp_path / "ptxas_0123456789abcdef.log").write_text(
        "== gemm_q.cu\n"
        "ptxas info    : Compiling entry function "
        "'_ZN12_GLOBAL__N_113gemm_q_kernelIfLb1EEEvPKT_S3_PKiS5_PS1_iiiii' for 'sm_90a'\n"
        "ptxas info    : Function properties for _ZN12_GLOBAL__N_113gemm_q_kernelIfLb1EEEv\n"
        "    0 bytes stack frame, 8 bytes spill stores, 12 bytes spill loads\n"
        "ptxas info    : Used 168 registers, used 1 barriers, 404 bytes cmem[0]\n")
    monkeypatch.setattr(_build, "build", lambda: lib)
    usage = smoke.ptxas_usage()
    stem = smoke.serving_instance("gemm_q_sparse_kernel", "float32")
    (key,) = [k for k in usage if stem in k]
    assert usage[key] == {"registers": 168, "spill_bytes": 20}
    assert smoke.serving_instance("gemm_o_sparse_bucketed_kernel", "bfloat16") \
        == "gemm_o_bucketed_kernelI13__nv_bfloat16Lb1E"
    assert smoke.serving_instance("flashomni_attention_csr", "float32") \
        == "csr_attention_kernelIfLi128ELi16E"


def test_count_walk_wants_a_cuda_device():
    from repro_torch.kernels.flashomni_attention import _walk_ptr, count_walk
    with pytest.raises(ValueError, match="CUDA"):
        with count_walk("cpu"):
            pass
    assert _walk_ptr(torch.device("cpu")) is None


def _global_kernels():
    """(source file, kernel name) of every ``__global__`` function in csrc/*.cu."""
    found = []
    for path in sorted((ROOT / "src" / "repro_torch" / "csrc").glob("*.cu")):
        for m in re.finditer(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)\s*\(",
                             path.read_text()):
            found.append((path.name, m.group(1)))
    assert len(found) >= 7
    return found


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("src,kernel", _global_kernels(), ids=lambda v: str(v))
def test_profile_groups_every_cuda_kernel_under_its_wrapper(src, kernel):
    smoke = _chip_smoke()
    # As torch.profiler names a template instance of the kernel.
    group = smoke._kernel_group(f"void (anonymous namespace)::{kernel}<float, 128, 16>(float "
                                "const*, int)")
    assert group in {fn.__name__ for fn in TK.KERNELS}, (src, kernel, group)
    assert smoke.SOURCES[group][0].endswith(f"csrc/{src}")


def test_profile_groups_cover_every_wrapper():
    smoke = _chip_smoke()
    groups = {smoke._kernel_group(kernel) for _, kernel in _global_kernels()}
    assert groups == {fn.__name__ for fn in TK.KERNELS}
