"""Launchers, port of ``repro.launch``: ``serve`` (diffusion and LM
serving), ``batching`` (stacked and continuous batched serving), ``train``
(the restartable training loop) and ``mesh`` (the engine mesh, the
production mesh and ``rules_for``).

Not applicable, each a GSPMD or TPU tool with no one-to-one torch meaning
(ROADMAP A.10.3): ``dryrun`` (lowers a step on a simulated 256-chip mesh
through ``jax.jit``), ``perf_probe`` and ``roofline_sweep`` (XLA cost
analysis of compiled steps against TPU peaks) and ``specs`` (jit +
``NamedSharding`` step factories for the dry-run).  ``steps``' step
builders are GSPMD programs too; their counterpart, a sharded train step
as FSDP over DTensor on :mod:`repro_torch.distributed.sharding`, is not
ported yet (ROADMAP A.10.1).
"""
