"""Launchers, port of ``repro.launch``: ``serve`` (diffusion and LM
serving), ``batching`` (stacked and continuous batched serving), ``train``
(the restartable training loop), ``mesh`` (the engine mesh, the
production mesh and ``rules_for``), ``specs`` (the input shape stand-ins
of every cell and their logical specs) and ``steps`` (the sharded step
builders: the train step as FSDP, prefill, decode and the DiT denoise
step, over DTensor on :mod:`repro_torch.distributed.sharding`).

Not applicable, each a GSPMD or TPU tool with no one-to-one torch meaning
(ROADMAP A.10.3): ``dryrun`` (lowers a step on a simulated 256-chip mesh
through ``jax.jit``), ``perf_probe`` and ``roofline_sweep`` (XLA cost
analysis of compiled steps against TPU peaks).
"""
