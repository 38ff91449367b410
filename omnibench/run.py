"""Run one cell of the port's benchmark once and print its result line.

    python3 omnibench/run.py --workload NAME --seed N --seconds S --trace 0|1

From the root of a checkout that holds ``BENCHMARK.json``, this folder and
``src/repro_torch``.  Exits 2 without a result when no CUDA card is there
(or fewer than the cell asks for), 3 when a JAX module or the old
``benchmarks`` package was loaded.  The last line of standard output is the
result's JSON object; the numbers the correctness check compared, with
their limits, are the last lines of standard error.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path.cwd()
HERE = Path(__file__).resolve().parent

# Every build and kernel cache inside the checkout, at fixed paths.
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                 ("TORCHINDUCTOR_CACHE_DIR", "inductor"), ("CUDA_CACHE_PATH", "cuda")):
    os.environ[var] = str(ROOT / ".omnibench_cache" / sub)
os.environ["USE_FLAX"] = "0"
sys.path[:0] = [str(HERE.parent), str(ROOT / "src")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch
    from omnibench import harness

    # One process drives the card; its host threads stay few so that they
    # contend with nothing.
    torch.set_num_threads(1)

    cell = harness.load_cell(ROOT, args.workload)["cell"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"omnibench: {cell['chips']} CUDA card(s) needed, "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found",
              file=sys.stderr)
        return 2
    try:
        power = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                "--format=csv,noheader"], capture_output=True, text=True,
                               timeout=60).stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        power = "unknown"
    print(f"omnibench: card {power}", file=sys.stderr)
    result = harness.run_cell(ROOT, args.workload, args.seed, args.seconds, bool(args.trace),
                              t_start=T_START)
    bad = harness.forbidden_modules()
    if bad:
        print(f"omnibench: the run loaded {bad}; no result", file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    checks = result["checks"]
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
