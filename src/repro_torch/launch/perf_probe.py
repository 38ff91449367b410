"""The perf probe, port of ``repro.launch.perf_probe``: trace ONE cell's
sharded step with a combination of perf options on ``meta`` tensors over a
fake world (:mod:`repro_torch.launch.dryrun`) and print its three roofline
terms against one NVIDIA H100 SXM at 700 W, and the dominant one
(hypothesis, change, re-trace, re-read).

  PYTHONPATH=src python -m repro_torch.launch.perf_probe --arch gemma3-1b \\
      --shape train_4k [--cast-bf16] [--moment-dtype bfloat16] \\
      [--cap-q-frac 0.6] [--mode update|dispatch] [--tag iterN]

The terms (:func:`~repro_torch.launch.dryrun.roofline_terms`, the figures
of :data:`~repro_torch.launch.dryrun.H100`): compute, bf16 FLOPs at 989e12
a second and every other FLOP at the f32 rate of 67e12 (the port runs f32
products with TF32 off); memory, bytes at 3.35e12 a second; collective,
wire bytes at 450e9 a second, NVLink one way.  The collective term is a
lower bound: a mesh axis that crosses hosts is slower, and is not
modelled.  Every layer is traced, as the reference's unrolled probe does.  These
are predictions made on the host, not measurements.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Optional

__all__ = ["probe", "main"]


def probe(arch: str, shape_name: str, *, multi_pod: bool = False, cast_bf16: bool = False,
          moment_dtype: str = "float32", mode: str = "dispatch",
          cap_q_frac: Optional[float] = None, cap_kv_frac: Optional[float] = None,
          tag: str = "probe", interval: Optional[int] = None,
          out: str = "artifacts/perf") -> dict:
    """Trace rank 0's step of one cell with the given options; print and
    write its roofline terms.  A DiT cell runs ``mode`` at the reference's
    mask (blocks 64, pool 256, ``interval`` 5 unless given) and capacities
    (``cap_q_frac`` 0.6, ``cap_kv_frac`` 0.9 unless given); a train cell
    takes ``cast_bf16`` (bf16 parameter gathers) and ``moment_dtype``."""
    from repro_torch.configs.registry import arch_shapes, get_config
    from repro_torch.launch.dryrun import (H100, fake_world, mesh_label, record_cell,
                                           roofline_terms)
    from repro_torch.launch.mesh import make_production_mesh, rules_for
    cfg = get_config(arch)
    shape = {s.name: s for s in arch_shapes(cfg)}[shape_name]
    kw: dict = {}
    if cfg.family == "dit":
        from repro_torch.core.engine import EngineConfig
        from repro_torch.core.masks import MaskConfig
        kw["mode"] = mode
        kw["ecfg"] = EngineConfig(
            mask=MaskConfig(tau_q=0.5, tau_kv=0.15, interval=interval or 5, order=1,
                            degrade=0.3, block_q=64, block_kv=64, pool=256),
            cap_q_frac=cap_q_frac or 0.6, cap_kv_frac=cap_kv_frac or 0.9)
    elif shape.kind == "train":
        from repro_torch.optim.optimizer import AdamWConfig
        kw["opt_cfg"] = AdamWConfig(moment_dtype=moment_dtype)
        kw["cast_params_bf16"] = cast_bf16
    with fake_world(512 if multi_pod else 256):
        mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
        fields = record_cell(cfg, shape, mesh, rules_for(cfg, shape, multi_pod=multi_pod),
                             **kw)
        label = mesh_label(mesh)
    terms = roofline_terms(fields)
    rec = {
        "tag": tag, "arch": arch, "shape": shape_name, "mesh": label,
        "opts": {"cast_bf16": cast_bf16, "moment_dtype": moment_dtype, "mode": mode,
                 "cap_q_frac": cap_q_frac, "cap_kv_frac": cap_kv_frac, "interval": interval},
        **terms, "flops": fields["flops_per_device"], "flops_by_dtype": fields["flops_by_dtype"],
        "bytes": fields["bytes_per_device"], "coll_wire_bytes": fields["wire_bytes"],
        "collectives": fields["collective_bytes"], "arg_bytes": fields["argument_bytes"],
        "peak_bytes": fields["peak_bytes"], "fits": fields["fits"],
        "trace_s": fields["trace_s"], "device": H100,
        "note": "predicted for one H100 SXM at 700 W from a host trace; the collective "
                "term is a lower bound (NVLink one way; axes across hosts not modelled)"}
    Path(out).mkdir(parents=True, exist_ok=True)
    path = Path(out) / f"{arch}__{shape_name}__{tag}.json"
    path.write_text(json.dumps(rec, indent=1))
    print(f"[perf] {arch} {shape_name} mesh{label} [{tag}] "
          f"compute={terms['t_compute_s']:.4g}s memory={terms['t_memory_s']:.4g}s "
          f"collective>={terms['t_collective_s']:.4g}s dom={terms['dominant']} "
          f"args={fields['argument_bytes'] / 1e9:.2f}GB peak={fields['peak_bytes'] / 1e9:.2f}GB "
          f"(H100 80 GB, 700 W; collective a lower bound) -> {path}")
    return rec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--cast-bf16", action="store_true")
    ap.add_argument("--moment-dtype", default="float32")
    ap.add_argument("--mode", default="dispatch")
    ap.add_argument("--cap-q-frac", type=float, default=None)
    ap.add_argument("--cap-kv-frac", type=float, default=None)
    ap.add_argument("--interval", type=int, default=None)
    ap.add_argument("--tag", default="probe")
    ap.add_argument("--out", default="artifacts/perf")
    args = ap.parse_args(argv)
    probe(args.arch, args.shape, multi_pod=args.multi_pod, cast_bf16=args.cast_bf16,
          moment_dtype=args.moment_dtype, mode=args.mode, cap_q_frac=args.cap_q_frac,
          cap_kv_frac=args.cap_kv_frac, interval=args.interval, tag=args.tag, out=args.out)


if __name__ == "__main__":
    main()
