"""Multi-rank execution of the engine, port of ``repro.distributed``:
:mod:`~repro_torch.distributed.plan_shard` (plan-sharded mesh dispatch over
``torch.distributed``).  The reference's GSPMD sharding rules, gradient
compression, collective matmul and context helpers are not ported yet
(ROADMAP A.10)."""
