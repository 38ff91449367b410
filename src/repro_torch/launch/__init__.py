"""Launchers, port of ``repro.launch``: ``serve`` (diffusion and LM
serving), ``batching`` (stacked and continuous batched serving), ``train``
(the restartable training loop), ``mesh`` (the engine mesh, the
production mesh and ``rules_for``), ``specs`` (the input shape stand-ins
of every cell and their logical specs), ``steps`` (the sharded step
builders: the train step as FSDP, prefill, decode and the DiT denoise
step, over DTensor on :mod:`repro_torch.distributed.sharding`), ``dryrun``
(one rank's step of every (arch × shape) cell traced on ``meta`` tensors
over a fake world of the production mesh's size and costed for one H100:
FLOPs, bytes, collective bytes, peak and whether it fits), ``perf_probe``
(one cell's roofline terms against the H100's peaks under perf options)
and ``roofline_sweep`` (every single-pod cell, smallest first).
"""
