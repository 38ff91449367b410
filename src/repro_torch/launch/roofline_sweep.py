"""The roofline sweep, port of ``repro.launch.roofline_sweep``: every
single-pod dry-run cell (:func:`repro_torch.launch.dryrun.run_cell`),
smallest first so results stream in early (by kind: decode, dit, prefill,
train; then by ``n_params · n_layers``).  Every layer is traced, as the
reference's unrolled sweep lowers it.  Failures are collected and printed
at the end.

  PYTHONPATH=src python -m repro_torch.launch.roofline_sweep
"""

from __future__ import annotations

from pathlib import Path

__all__ = ["main"]

_KIND_W = {"decode": 0, "dit": 1, "prefill": 2, "train": 3}


def main() -> None:
    from repro_torch.configs.registry import ARCH_IDS, arch_shapes, get_config
    from repro_torch.launch.dryrun import run_cell
    cells = []
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        for sh in arch_shapes(cfg):
            cells.append(((_KIND_W[sh.kind], cfg.n_params() * cfg.n_layers), arch, sh.name))
    cells.sort()
    out = Path("artifacts/dryrun")
    fails = []
    for _, arch, sh in cells:
        try:
            run_cell(arch, sh, False, out)
        except Exception as e:  # noqa: BLE001 — record and go on to the next cell
            fails.append((arch, sh, repr(e)))
            print(f"[roofline-sweep] FAIL {arch} {sh}: {e}")
    print(f"done, {len(cells)} cells, {len(fails)} failures: {fails}")


if __name__ == "__main__":
    main()
