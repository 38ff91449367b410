"""Multi-rank execution, port of ``repro.distributed``, every module of it
over ``torch.distributed``:

* :mod:`~repro_torch.distributed.plan_shard` — plan-sharded mesh dispatch;
* :mod:`~repro_torch.distributed.compression` — gradient compression with
  error feedback;
* :mod:`~repro_torch.distributed.sharding` — logical-axis sharding rules,
  mapped onto DTensor placements over a named ``DeviceMesh``;
* :mod:`~repro_torch.distributed.ctx` — the activation-rules context and
  ``constrain``;
* :mod:`~repro_torch.distributed.collective_matmul` — the all-gather matmul
  as a ring of point-to-point steps;
* :mod:`~repro_torch.distributed.tensor_parallel` — Megatron's operators
  over the ``model`` row and the step builders' one-block-at-a-time
  parameter gather.

The step builders that lay a step out by the rules (the train step as
FSDP over DTensor, prefill, decode and the DiT denoise step) are
:mod:`repro_torch.launch.steps`."""
