"""The port's long-context sparse decode (``repro_torch.long_context_lm``)
against ``examples/long_context_lm.py``'s body, in the same process.

The example's inputs are built in JAX from ``PRNGKey(0)`` exactly as the
example builds them and carried across through numpy; the block selection
must be the reference's exactly (on equal scores the lower block index
wins), the sparse output within 1e-5 of
``repro.core.attention.sparse_decode_attention`` and the relative error
within 1e-6 of the reference's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.attention import sparse_decode_attention as j_sparse_decode
from repro.core.masks import pool_tokens as j_pool_tokens
from repro.core.symbols import active_indices as j_active_indices
from repro.core.symbols import clamp_mask_topk as j_clamp_mask_topk
from repro_torch import long_context_lm as LC

OUT_ATOL = 1e-5
REL_ATOL = 1e-6


def example_inputs(b, h, s, dh, block):
    """``examples/long_context_lm.py:20-32``, verbatim in JAX."""
    key = jax.random.PRNGKey(0)
    ks = jax.random.split(key, 4)
    k_cache = jax.random.normal(ks[0], (b * h, s, dh))
    v_cache = jax.random.normal(ks[1], (b * h, s, dh))
    q = jax.random.normal(ks[2], (b * h, 1, dh))
    hot = jax.random.bernoulli(ks[3], 0.12, (b * h, s // block))
    hot_tok = jnp.repeat(hot, block, axis=-1)[..., None]
    k_cache = jnp.where(hot_tok, k_cache * 0.3 + q * 1.2, k_cache * 0.3)
    return q, k_cache, v_cache


@jax.jit
def _j_scores(q, k_cache):
    return jnp.einsum("bnd,btd->bt", q[:, 0:1], j_pool_tokens(k_cache, 64))


def reference(q, k_cache, v_cache, block, keep_frac):
    """The example's body after its inputs (lines 34-45)."""
    t = k_cache.shape[1] // block
    kp = j_pool_tokens(k_cache, block)
    scores = jnp.einsum("bnd,btd->bt", q[:, 0:1], kp)
    cap = max(int(t * keep_frac), 1)
    keep = j_clamp_mask_topk(jnp.ones_like(scores, bool), scores, cap)
    kv_ids, kv_cnt = j_active_indices(keep, cap)
    sparse = j_sparse_decode(q, k_cache, v_cache, kv_ids, kv_cnt, block)
    s = jnp.einsum("bnd,bsd->bns", q, k_cache) * q.shape[-1] ** -0.5
    dense = jnp.einsum("bns,bsd->bnd", jax.nn.softmax(s, -1), v_cache)
    rel = float(jnp.linalg.norm(sparse - dense) / jnp.linalg.norm(dense))
    return (np.asarray(kv_ids), np.asarray(kv_cnt), np.asarray(sparse), np.asarray(dense),
            rel)


def check_against_reference(q, k_cache, v_cache, block=64, keep_frac=0.25):
    want_ids, want_cnt, want_sparse, want_dense, want_rel = reference(
        q, k_cache, v_cache, block, keep_frac)
    got = LC.select_and_attend(*(torch.from_numpy(np.array(a)) for a in (q, k_cache, v_cache)),
                               block=block, keep_frac=keep_frac)
    np.testing.assert_array_equal(got.kv_ids.numpy(), want_ids)
    np.testing.assert_array_equal(got.kv_cnt.numpy(), want_cnt)
    np.testing.assert_allclose(got.sparse.numpy(), want_sparse, rtol=0, atol=OUT_ATOL)
    np.testing.assert_allclose(got.dense.numpy(), want_dense, rtol=0, atol=OUT_ATOL)
    assert abs(got.rel - want_rel) <= REL_ATOL, (got.rel, want_rel)
    return got, want_rel


def test_the_example_at_its_size_matches_the_reference():
    d = LC.DEFAULTS
    got, rel = check_against_reference(*example_inputs(d["b"], d["h"], d["s"], d["dh"],
                                                       d["block"]))
    assert got.kv_ids.shape == (8, 32) and (got.kv_cnt == 32).all()
    assert rel < 0.2          # the planted structure makes 25 % of blocks enough


def test_planted_score_ties_keep_the_lower_block_index():
    """Blocks copied from one another score exactly alike; the cap falls
    inside a run of equal scores, and the lower indices are kept."""
    b, h, s, dh, block = 1, 2, 2048, 64, 64
    q, k_cache, v_cache = (np.array(a) for a in example_inputs(b, h, s, dh, block))
    t = s // block
    blocks = k_cache.reshape(b * h, t, block, dh)
    for j in range(t):                    # three distinct blocks, repeated
        blocks[:, j] = blocks[:, j % 3]
    k_cache = blocks.reshape(b * h, s, dh)
    scores = np.asarray(_j_scores(q, k_cache))
    cap = LC.keep_cap(t, 0.25)
    for row in range(b * h):              # the best block's 11 copies tie
        top = np.sort(scores[row])[::-1]
        assert top[cap - 1] == top[cap]   # and the cap of 8 splits them
    got, _ = check_against_reference(q, k_cache, v_cache)
    for row in range(b * h):
        best = int(np.argmax(scores[row, :3]))
        assert got.kv_ids[row].tolist() == [j for j in range(t) if j % 3 == best][:cap]


def test_make_inputs_plants_the_structure():
    q, k_cache, v_cache = LC.make_inputs(1, 2, 1024, 16, 64, seed=3)
    assert q.shape == (2, 1, 16) and k_cache.shape == v_cache.shape == (2, 1024, 16)
    again = LC.make_inputs(1, 2, 1024, 16, 64, seed=3)
    assert all(torch.equal(a, b) for a, b in zip((q, k_cache, v_cache), again))
    # Hot blocks carry q·1.2 on top of k·0.3: their pooled keys align with q.
    scores = torch.einsum("bd,btd->bt", q[:, 0], k_cache.reshape(2, 16, 64, 16).mean(2))
    hot = scores > 0.5 * q.pow(2).sum(-1, keepdim=True) * 1.2
    assert 0 < int(hot.sum()) < 32


def test_main_runs_on_the_cpu(capsys):
    out = LC.main(["--device", "cpu", "--context", "2048"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "context 2048 tokens, reading 25% of KV blocks"
    assert lines[1] == f"relative error vs full attention: {out.rel:.4f}"
    assert lines[2] == "cache reads reduced 4x (decode is HBM-bound -> ~4x step speedup)"
    assert out.kv_ids.shape == (8, 8) and np.isfinite(out.rel)


def test_main_runs_the_default_size_on_the_cpu(capsys):
    out = LC.main(["--device", "cpu"])
    assert "context 8192 tokens" in capsys.readouterr().out
    assert out.sparse.shape == (8, 1, 64)


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the refusal without a card")
def test_main_refuses_the_card_without_one():
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LC.main([])
