"""Port parity: the decoder-only LM layers (``repro_torch.models.layers`` vs
``repro.models.layers`` on the same numpy-seeded inputs, f32).

RoPE (the prefill and the decode broadcast), the chunked GQA attention
(causal, windowed, with a query offset, with a short last chunk), the banded
local attention on both sides of ``s = 2·window`` and against the windowed
GQA attention, the decode attention (and its partials over the shards of a
cache split along its sequence, merged, against it on the whole cache), the
gated MLP, the capacity-routed MoE
with planted router ties and a capacity overflow (expert ids, buffer
positions and the keep mask exact; the reference's routing lines,
layers.py:300-308, run here on the same probabilities) and the z-loss cross
entropy, at rtol = atol = 1e-5 unless a test says otherwise.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as JL
from repro_torch.models import layers as TL

TOL = dict(rtol=1e-5, atol=1e-5)


def _rng(seed):
    return np.random.default_rng(seed)


def _normal(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _close(got, want, **kw):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **{**TOL, **kw})


# --- RoPE ---------------------------------------------------------------------

@pytest.mark.parametrize("theta", [10000.0, 1_000_000.0])
def test_rope_table(theta):
    pos = np.arange(0, 300, 7, dtype=np.int32)
    jc, js = JL.rope_table(jnp.asarray(pos), 64, theta)
    tc, ts = TL.rope_table(_t(pos), 64, theta)
    assert tc.dtype == torch.float32 and tc.shape == (len(pos), 32)
    _close(tc, jc)
    _close(ts, js)


@pytest.mark.parametrize("shape, cos_rows", [
    ((2, 9, 4, 16), 9),          # prefill: (B,S,H,dh) against (S, dh/2)
    ((3, 1, 4, 16), 1),          # decode: (B,1,H,dh) against (1, dh/2)
    ((2, 9, 16), 9),             # (B,S,dh) against (S, dh/2)
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_rope_both_broadcasts(shape, cos_rows, dtype):
    rng = _rng(1)
    x = _normal(rng, *shape)
    pos = np.arange(5, 5 + cos_rows, dtype=np.int32)
    jc, js = JL.rope_table(jnp.asarray(pos), shape[-1])
    tc, ts = TL.rope_table(_t(pos), shape[-1])
    jx = jnp.asarray(x).astype(dtype)
    tx = _t(x).to(getattr(torch, dtype))
    want = JL.apply_rope(jx, jc, js)
    got = TL.apply_rope(tx, tc, ts)
    assert got.dtype == tx.dtype and got.shape == tx.shape
    if dtype == "float32":
        _close(got, want)
    else:   # one bf16 rounding of the same f32 values
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                                   rtol=1e-2, atol=1e-2)


# --- attention ------------------------------------------------------------------

def _qkv(seed, b, s, h, hkv, dh, skv=None):
    rng = _rng(seed)
    skv = s if skv is None else skv
    return (_normal(rng, b, s, h, dh), _normal(rng, b, skv, hkv, dh),
            _normal(rng, b, skv, hkv, dh))


@functools.lru_cache(maxsize=None)
def _j_gqa(**kw):
    return jax.jit(functools.partial(JL.gqa_attention, **kw))


@pytest.mark.parametrize("kw, s, skv", [
    (dict(causal=True), 48, None),
    (dict(causal=True, chunk=16), 40, None),                  # short last chunk
    (dict(causal=True, window=8, chunk=16), 40, None),
    (dict(causal=True, q_offset=24, chunk=16), 20, 44),       # queries after a prefix
    (dict(causal=True, q_offset=5, window=6, chunk=8), 13, 18),
    (dict(causal=False, chunk=16), 24, 30),
    (dict(causal=True, scale=0.3), 17, None),
])
def test_gqa_attention(kw, s, skv):
    q, k, v = _qkv(2, 2, s, 4, 2, 16, skv)
    want = _j_gqa(**kw)(q, k, v)
    got = TL.gqa_attention(_t(q), _t(k), _t(v), **kw)
    _close(got, want)


@pytest.mark.parametrize("s, window, chunk", [
    (40, 16, None),      # s > 2 window: the layer path takes this one
    (32, 16, None),      # s = 2 window
    (20, 16, None),      # s < 2 window: a single padded chunk
    (45, 8, None),       # several chunks, the last padded
    (37, 8, 5),          # chunk shorter than the window
])
def test_local_attention(s, window, chunk):
    q, k, v = _qkv(3, 2, s, 4, 1, 16)
    want = jax.jit(functools.partial(JL.local_attention, window=window, chunk=chunk))(q, k, v)
    got = TL.local_attention(_t(q), _t(k), _t(v), window=window, chunk=chunk)
    _close(got, want)
    # The banded path and the windowed GQA attention compute the same function.
    _close(got, TL.gqa_attention(_t(q), _t(k), _t(v), causal=True, window=window,
                                 chunk=16).numpy())


@pytest.mark.parametrize("window", [None, 5])
def test_decode_attention(window):
    rng = _rng(4)
    q = _normal(rng, 3, 1, 4, 16)
    kc, vc = _normal(rng, 3, 12, 2, 16), _normal(rng, 3, 12, 2, 16)
    cache_len = np.array([1, 7, 12], np.int32)
    want = JL.decode_attention(q, kc, vc, jnp.asarray(cache_len), window=window)
    got = TL.decode_attention(_t(q), _t(kc), _t(vc), _t(cache_len), window=window)
    _close(got, want)


def test_decode_attention_with_no_live_slot_averages_like_the_reference():
    """``_NEG_INF`` is finite: a row with no live slot gets uniform weights."""
    rng = _rng(5)
    q, kc, vc = _normal(rng, 1, 1, 2, 8), _normal(rng, 1, 6, 1, 8), _normal(rng, 1, 6, 1, 8)
    cache_len = np.zeros((1,), np.int32)
    want = JL.decode_attention(q, kc, vc, jnp.asarray(cache_len))
    got = TL.decode_attention(_t(q), _t(kc), _t(vc), _t(cache_len))
    _close(got, want)
    _close(got[0, 0, 0], vc[0, :, 0].mean(axis=0))


# Shards of a 12-slot cache (their slot counts, in order) and the decode
# window: even, uneven, with empty shards (no slot, and slots past every
# row's live length), and windowed.
PARTIAL_CASES = {"even": ((6, 6), None), "uneven": ((5, 4, 3), None),
                 "empty": ((0, 3, 9, 0), None), "window": ((4, 4, 4), 3)}


@pytest.mark.parametrize("case", PARTIAL_CASES)
def test_decode_attention_partials_merged_match_the_whole_cache(case):
    sizes, window = PARTIAL_CASES[case]
    rng = _rng(7)
    q = _t(_normal(rng, 3, 1, 4, 16))
    kc, vc = _t(_normal(rng, 3, 12, 2, 16)), _t(_normal(rng, 3, 12, 2, 16))
    cache_len = _t(np.array([1, 7, 12], np.int32))       # row 0: one live slot, in shard 0
    want = TL.decode_attention(q, kc, vc, cache_len, window=window)
    starts = np.cumsum((0,) + sizes[:-1])
    parts = [TL.decode_attention_partial(q, kc[:, lo:lo + n], vc[:, lo:lo + n], cache_len,
                                         int(lo), window=window)
             for lo, n in zip(starts, sizes)]
    o, lse = torch.stack([p[0] for p in parts]), torch.stack([p[1] for p in parts])
    assert torch.isfinite(o).all() and not torch.isnan(lse).any()
    # Row 0's one live slot is slot 0: every other shard holds none there.
    holds_slot0 = torch.tensor([lo == 0 and n > 0 for lo, n in zip(starts, sizes)])
    assert (lse[~holds_slot0, 0] == float("-inf")).all()
    assert torch.isfinite(lse[holds_slot0, 0]).all()
    got = TL.merge_decode_partials(o, lse, lse.amax(dim=0), lambda t: t.sum(dim=0))
    assert torch.isfinite(got).all()
    _close(got[:, None], want)


# --- MLP, MoE, loss ----------------------------------------------------------------

def test_mlp():
    rng = _rng(6)
    p = {"wi": _normal(rng, 32, 48, scale=0.2), "wg": _normal(rng, 32, 48, scale=0.2),
         "wo": _normal(rng, 48, 32, scale=0.2)}
    x = _normal(rng, 2, 7, 32)
    _close(TL.mlp({k: _t(w) for k, w in p.items()}, _t(x)), JL.mlp(p, x))


def _j_route(probs, top_k, cap):
    """The reference's routing, layers.py:300-308, on the given probabilities."""
    e = probs.shape[-1]
    gates, eids = jax.lax.top_k(probs, top_k)
    gates = gates / jnp.sum(gates, axis=-1, keepdims=True)
    flat_e = eids.reshape(-1)
    onehot = jax.nn.one_hot(flat_e, e, dtype=jnp.int32)
    pos = jnp.cumsum(onehot, axis=0) - 1
    flat_pos = jnp.sum(pos * onehot, axis=-1)
    return gates, eids, flat_pos, flat_pos < cap


def _moe_params(seed, d, f, e, zero_experts=()):
    rng = _rng(seed)
    p = {"router": _normal(rng, d, e, scale=d ** -0.5),
         "wi": _normal(rng, e, d, f, scale=d ** -0.5),
         "wg": _normal(rng, e, d, f, scale=d ** -0.5),
         "wo": _normal(rng, e, f, d, scale=f ** -0.5)}
    p["router"][:, list(zero_experts)] = 0.0        # their logits tie at exactly 0
    return p


@pytest.mark.parametrize("case", ["all_tied", "some_tied", "untied"])
@pytest.mark.parametrize("capacity_factor", [1.25, 0.5])
def test_moe_mlp_ties_and_overflow(case, capacity_factor):
    """Router ties are planted as experts whose logits are exactly 0: with
    every column zero all experts tie for every token, so each token picks
    experts 0..k-1 (the lower index first) and those overflow their
    capacity; with some columns zero, tokens whose other logits are negative
    rank the tied experts first.  Ids, positions and keep mask are exact."""
    d, f, e, k, b, s = 16, 24, 8, 3, 2, 11
    zero = {"all_tied": range(e), "some_tied": (1, 3, 4, 6), "untied": ()}[case]
    p = _moe_params(7, d, f, e, zero)
    x = _normal(_rng(8), b, s, d)
    tp = {key: _t(w) for key, w in p.items()}
    n = b * s
    cap = int(capacity_factor * n * k / e) + 1
    probs = torch.softmax(_t(x).reshape(n, d) @ tp["router"], dim=-1)
    gates, eids, pos, keep = TL.moe_route(probs, k, cap)
    jg, je, jpos, jkeep = _j_route(jnp.asarray(probs.numpy()), k, cap)
    np.testing.assert_array_equal(eids.numpy(), np.asarray(je))
    np.testing.assert_array_equal(pos.numpy(), np.asarray(jpos))
    np.testing.assert_array_equal(keep.numpy(), np.asarray(jkeep))
    _close(gates, jg)
    if case == "all_tied":
        assert (eids.numpy() == np.arange(k)).all()
    if case != "untied":
        row = np.sort(probs.numpy(), axis=-1)[:, ::-1]
        assert (row[:, :k - 1] == row[:, 1:k]).any()           # a tie inside the top k
    if case == "all_tied" or capacity_factor < 1:
        assert not keep.all()                                   # an overflow
    want_y, want_aux = jax.jit(functools.partial(
        JL.moe_mlp, top_k=k, capacity_factor=capacity_factor))(p, x)
    y, aux = TL.moe_mlp(tp, _t(x), top_k=k, capacity_factor=capacity_factor)
    _close(y, want_y)
    _close(aux, want_aux)


def test_moe_mlp_overflow_drops_slots():
    """At capacity factor 0.5 some slots are dropped: each dropped slot's
    token gets nothing from that expert, in the port as in the reference."""
    d, f, e, k = 16, 24, 4, 2
    p = _moe_params(9, d, f, e)
    x = _normal(_rng(10), 1, 16, d)
    tp = {key: _t(w) for key, w in p.items()}
    probs = torch.softmax(_t(x)[0] @ tp["router"], dim=-1)
    cap = int(0.5 * 16 * k / e) + 1
    _, _, _, keep = TL.moe_route(probs, k, cap)
    assert 0 < int(keep.sum()) < keep.numel()
    y, _ = TL.moe_mlp(tp, _t(x), top_k=k, capacity_factor=0.5)
    want, _ = JL.moe_mlp(p, x, top_k=k, capacity_factor=0.5)
    _close(y, want)


def test_moe_mlp_in_bf16_promotes_like_the_reference():
    """bf16 activations against f32 expert weights: the router and the
    experts run in f32 (jnp's promotion), the output is bf16 (rtol = atol =
    1e-2, the order of one bf16 rounding)."""
    p = _moe_params(12, 32, 32, 8)
    x = _normal(_rng(13), 2, 20, 32)
    want, want_aux = JL.moe_mlp(p, jnp.asarray(x).astype(jnp.bfloat16), top_k=4)
    got, aux = TL.moe_mlp({key: _t(w) for key, w in p.items()}, _t(x).bfloat16(), top_k=4)
    assert got.dtype == torch.bfloat16
    _close(got.float(), want.astype(jnp.float32), rtol=1e-2, atol=1e-2)
    _close(aux, want_aux)


def test_softmax_xent():
    rng = _rng(11)
    logits = _normal(rng, 2, 9, 37, scale=3.0)
    labels = rng.integers(0, 37, (2, 9)).astype(np.int32)
    want = JL.softmax_xent(logits, labels)
    got = TL.softmax_xent(_t(logits), _t(labels))
    _close(got, want)
    _close(TL.softmax_xent(_t(logits), _t(labels), z_loss=0.0),
           JL.softmax_xent(logits, labels, z_loss=0.0))


def test_inits_have_the_reference_shapes():
    key = jax.random.PRNGKey(0)
    g = torch.Generator().manual_seed(0)
    want = JL.init_attention(key, 32, 4, 2, 8, stack=3, qk_norm=True)[0]
    got = TL.init_attention(g, 32, 4, 2, 8, stack=(3,), qk_norm=True, device="cpu")
    assert {k: tuple(v.shape) for k, v in got.items()} == \
        {k: tuple(v.shape) for k, v in want.items()}
    want = JL.init_moe(key, 32, 16, 6, stack=2)[0]
    got = TL.init_moe(g, 32, 16, 6, stack=(2,), device="cpu")
    assert {k: tuple(v.shape) for k, v in got.items()} == \
        {k: tuple(v.shape) for k, v in want.items()}
    # The reference's scales: N(0, d_in^-1/2) dense weights, ones for norms.
    w = TL.init_dense(torch.Generator().manual_seed(1), 256, 512, device="cpu")
    assert abs(float(w.std()) - 256 ** -0.5) < 2e-3
    assert torch.equal(TL.init_rmsnorm(8, stack=(2,), device="cpu"), torch.ones(2, 8))
