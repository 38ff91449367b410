"""Port parity: the sampler and sequential serving (repro_torch vs
``repro.diffusion.pipeline.sample`` on the XLA backend) at the flux-mmdit
smoke size with the serving launcher's MaskConfig (block 16, pool 32,
interval 4, warmup 2) and 96 vision tokens (N = 128).

8 steps cover Update (0, 1, 2, 6) and Dispatch (3, 4, 5, 7) steps.  The
weights are the reference's ``dit.init_params`` moved across through
``repro_torch.convert.params_from_jax``; latents, text and the stub
patchifier are numpy draws handed to both.  Serving is held against one
reference ``sample`` per request, not against the reference batcher.
Tolerances: latents f32 rtol 1e-3 / atol 1e-4; per-step density and pair
sparsity 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_smoke as j_get_smoke
from repro.core.engine import EngineConfig as JEngineConfig
from repro.core.masks import MaskConfig as JMaskConfig
from repro.diffusion.pipeline import SamplerConfig as JSamplerConfig
from repro.diffusion.pipeline import sample as j_sample
from repro.models import dit as jdit
from repro_torch.configs.registry import get_smoke
from repro_torch.convert import params_from_jax
from repro_torch.diffusion.pipeline import SamplerConfig, sample
from repro_torch.launch.batching import Request, run_sequential
from repro_torch.launch.serve import serving_engine_config

STEPS, BATCH, N_VISION = 8, 2, 96


@pytest.fixture(scope="module")
def reference():
    """Two requests through the reference sampler, and the shared inputs."""
    jcfg = j_get_smoke("flux-mmdit")
    jecfg = JEngineConfig(mask=JMaskConfig(
        tau_q=0.5, tau_kv=0.15, interval=4, order=1, degrade=0.3,
        block_q=16, block_kv=16, pool=32, warmup_steps=2))
    jparams = jdit.init_params(jcfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(2024)
    pe = (rng.standard_normal((jcfg.patch_dim, jcfg.d_model)) * 0.2).astype(np.float32)
    reqs = []
    for _ in range(2):
        x0 = rng.standard_normal((BATCH, N_VISION, jcfg.patch_dim)).astype(np.float32)
        text = rng.standard_normal((BATCH, jcfg.n_text_tokens, jcfg.d_model)).astype(np.float32)
        trace = []
        out = j_sample(jparams, jcfg, jecfg, text_emb=jnp.asarray(text), x0=jnp.asarray(x0),
                       scfg=JSamplerConfig(num_steps=STEPS), patch_embed=jnp.asarray(pe),
                       trace=trace)
        reqs.append((x0, text, np.asarray(out), trace))
    params = params_from_jax(jax.tree.map(np.asarray, jparams))
    return params, torch.from_numpy(pe), reqs


def _check(out, trace, want_out, want_trace):
    np.testing.assert_allclose(out.numpy(), want_out, rtol=1e-3, atol=1e-4)
    assert [s["kind"] for s in trace] == [s["kind"] for s in want_trace]
    for got, want in zip(trace, want_trace):
        assert abs(got["density"] - want["density"]) <= 1e-6, (got, want)
        assert abs(got["pair_sparsity"] - want["pair_sparsity"]) <= 1e-6, (got, want)


def test_sample_matches_reference(reference):
    params, pe, reqs = reference
    x0, text, want_out, want_trace = reqs[0]
    trace = []
    out = sample(params, get_smoke("flux-mmdit"), serving_engine_config(),
                 text_emb=torch.from_numpy(text), x0=torch.from_numpy(x0), patch_embed=pe,
                 scfg=SamplerConfig(num_steps=STEPS), trace=trace)
    assert [s["kind"] for s in trace].count("dispatch") == 4
    assert min(s["density"] for s in trace) < 1.0          # the engine went sparse
    _check(out, trace, want_out, want_trace)


def test_run_sequential_matches_per_request_reference(reference):
    params, pe, reqs = reference
    requests = [Request(rid=i, x0=torch.from_numpy(x0), text_emb=torch.from_numpy(text),
                        num_steps=STEPS, arrival=0.0)
                for i, (x0, text, _, _) in enumerate(reqs)]
    results = run_sequential(params, get_smoke("flux-mmdit"), serving_engine_config(),
                             requests, patch_embed=pe)
    assert sorted(results) == [0, 1]
    for i, (_, _, want_out, want_trace) in enumerate(reqs):
        r = results[i]
        assert r["latency"] >= 0 and r["finish"] >= r["latency"]
        _check(r["out"], r["trace"], want_out, want_trace)
