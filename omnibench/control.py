"""The control of the correctness check, and the program's readings beside
it, on the card at a cell's own size.

    python3 omnibench/control.py --workload NAME --seeds 11,12,13 --steps K

For each seed: the cell's weights and its first request from the seed, the
program (``pipeline.sample``) for the request's first ``K`` steps, the plain
reference (:mod:`omnibench.reference`) in the configuration's precision and
the control, the same reference with every matmul and attention operand
rounded to float8 e4m3 (the precision below bf16).  Prints one JSON line a
seed: the number the check compares (``check.latent_gap``) for the program
and for the control against the reference.  The benchmark's runs do not run
this; PERF.md gives the readings the limits were set from.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path.cwd()
sys.path[:0] = [str(Path(__file__).resolve().parents[1]), str(ROOT / "src")]


def readings(root, workload: str, seed: int, steps: int, with_control=True,
             device="cuda") -> dict:
    import torch
    from omnibench import check, harness
    from omnibench.reference import Reference, fp8_round
    from repro_torch.diffusion.pipeline import SamplerConfig, sample
    c = harness.load_cell(Path(root), workload)
    cfg, traffic = c["config"], c["traffic"]
    device = torch.device(device)
    dtype = getattr(torch, cfg["dtype"])
    arch, ecfg = harness.program_configs(cfg)
    params = harness.make_weights(cfg, seed, device, dtype)
    pe = harness.patch_embed(cfg, seed, device)
    x0, text = harness.request_inputs(cfg, traffic, seed, 0, device)
    t0 = time.perf_counter()
    log = harness.StepLog(limit=steps)
    try:
        sample(params, arch, ecfg, text_emb=text, x0=x0, patch_embed=pe,
               scfg=SamplerConfig(num_steps=traffic["steps"], dtype=dtype), trace=log,
               schedule=cfg["schedule"])
    except harness.WindowClosed:
        pass
    program = {step: x for (_, step), x in log.latents.items()}
    t1 = time.perf_counter()
    ref = Reference(cfg, params, dtype=dtype)
    prog_gap = check.latent_gap(ref, x0, text, pe, program, traffic["steps"])
    t2 = time.perf_counter()
    ctrl_gap = None
    if with_control:
        control = {}
        Reference(cfg, params, dtype=dtype, rnd=fp8_round).run(
            x0, text, pe, traffic["steps"], steps, lambda i, x: control.__setitem__(i, x))
        ctrl_gap = check.latent_gap(ref, x0, text, pe, control, traffic["steps"])
    return {"workload": workload, "seed": seed, "steps": steps, "program": prog_gap,
            "control": ctrl_gap, "program_s": t1 - t0, "reference_s": t2 - t1,
            "kinds": [s["kind"] for s in log]}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--steps", type=int, required=True)
    ap.add_argument("--control", type=int, choices=(0, 1), default=1,
                    help="0: the program's readings alone")
    args = ap.parse_args()
    for seed in (int(s) for s in args.seeds.split(",")):
        print(json.dumps(readings(ROOT, args.workload, seed, args.steps, args.control)),
              flush=True)


if __name__ == "__main__":
    main()
