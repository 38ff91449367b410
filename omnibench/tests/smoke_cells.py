"""Smoke-size cells for the CPU tests: a checkout-like root in a temporary
directory holding a ``BENCHMARK.json``, this benchmark's metric readers and
smoke configurations of both configurations' rules."""

from __future__ import annotations

import copy
import json
import shutil
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
REPO = BENCH.parent

SMOKE = {"n_layers": 3, "d_model": 96, "n_heads": 3, "head_dim": 32, "d_ff": 192,
         "n_text_tokens": 32, "patch_dim": 16}
TRAFFIC = {"batch": 1, "steps": 28, "n_vision": 96}


def smoke_config(name: str) -> dict:
    cfg = json.loads((BENCH / "configs" / f"{name}.json").read_text())
    cfg.update(SMOKE)
    return cfg


def make_root(tmp: Path, limit: float = 1.0, extra_metric: str = None) -> Path:
    """A root with the cells ``flux-smoke`` and ``hunyuan-smoke`` (the two
    configurations' rules at smoke size) and the real metric readers."""
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    spec = copy.deepcopy(spec)
    folder = tmp / BENCH.name
    for sub in ("configs", "traffic", "limits"):
        (folder / sub).mkdir(parents=True, exist_ok=True)
    shutil.copytree(BENCH / "metrics", folder / "metrics", dirs_exist_ok=True)
    spec["configs"], spec["workloads"] = [], []
    for src, cell in (("flux-mmdit", "flux-smoke"), ("hunyuan-video-dit", "hunyuan-smoke")):
        (folder / "configs" / f"{cell}.json").write_text(json.dumps(smoke_config(src)))
        spec["configs"].append({"name": cell, "source": "https://example.org",
                                "file": f"{BENCH.name}/configs/{cell}.json", "reduced": [],
                                "why": "smoke"})
        spec["workloads"].append({"name": cell, "config": cell, "traffic": "smoke",
                                  "chips": 1, "why": "smoke"})
        (folder / "limits" / f"{cell}.json").write_text(
            json.dumps({"latent_rel_l2": {"limit": limit}}))
    (folder / "traffic" / "smoke.json").write_text(json.dumps(TRAFFIC))
    for m in spec["per_layer"]:
        m.pop("workloads", None)
    (tmp / "BENCHMARK.json").write_text(json.dumps(spec))
    return tmp
