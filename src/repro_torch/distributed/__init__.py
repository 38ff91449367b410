"""Multi-rank execution of the engine, port of ``repro.distributed``:
:mod:`~repro_torch.distributed.plan_shard` (plan-sharded mesh dispatch over
``torch.distributed``) and :mod:`~repro_torch.distributed.compression`
(gradient compression with error feedback).  The reference's GSPMD sharding
rules, collective matmul and context helpers are not ported yet (ROADMAP
A.10)."""
