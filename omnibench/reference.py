"""Plain PyTorch reference of one served request: the single-stream MMDiT
sampled by rectified-flow Euler steps, with FlashOmni's Update and Dispatch
steps (paper §3.2-3.5) worked out again from the configuration file.

It imports nothing of the program.  From the benchmark it takes the weights
and the request's inputs, which the benchmark made from the seed; every
symbol, plan and cached block it works out itself:

* Update: dense attention (``scaled_dot_product_attention``), the sparse
  symbols from the pooled attention map (the caching mask from the
  vision-to-text contribution and the text-to-vision guidance, the skip
  mask by cumulative mass, degradation, the static-capacity clamps), the
  cache bias of the cached heads and its first-order Taylor difference,
  and the row clamp of the plan (rows live in any head, ranked by the
  summed clamp scores of their live heads).
* Dispatch: each live (row, head) attends its live KV blocks; a cached one
  contributes nothing but the Taylor forecast of the cache bias, added in
  output space.

Matmuls and attention run in ``dtype`` (the configuration's), norms,
softmaxes and the map in float32.  ``rnd`` rounds every matmul and
attention operand first: the identity for the reference, a lower precision
for the control (:func:`fp8_round`).
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch
import torch.nn.functional as F

__all__ = ["Reference", "fp8_round", "step_modes", "strategy_table"]

# Elements of one chunk of a Dispatch step's token mask.
_MASK_ELEMS = 1 << 30


def fp8_round(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 with one scale per tensor (its largest
    magnitude at 448), returned in ``t``'s dtype."""
    amax = t.detach().abs().amax().float().clamp(min=1e-12)
    scale = amax / 448.0
    return ((t.float() / scale).to(torch.float8_e4m3fn).float() * scale).to(t.dtype)


def step_modes(num_steps: int, warmup: int, interval: int) -> list[str]:
    """Each step's phase: Update for the warmup steps and every
    ``interval``-th step after them, Dispatch otherwise."""
    return ["update" if i < warmup or (i - warmup) % interval == 0 else "dispatch"
            for i in range(num_steps)]


def strategy_table(cfg: dict) -> list[list[str]]:
    """Per layer, each head's symbol rule: the file's ``layer_strategies``
    (a layer entry overrides the head template, which repeats over the
    heads)."""
    table = cfg["layer_strategies"]
    out = []
    for li in range(cfg["n_layers"]):
        tmpl = table.get("layers", {}).get(str(li), table["heads"])
        out.append([tmpl[h % len(tmpl)] for h in range(cfg["n_heads"])])
    return out


def _rms(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    return (xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps) * scale.float()).to(x.dtype)


def _modulate(x, shift, scale):
    return x * (1 + scale[:, None]) + shift[:, None]


def _time_embedding(t: torch.Tensor, dim: int = 256) -> torch.Tensor:
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(half, dtype=torch.float32,
                                                        device=t.device) / half)
    ang = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(ang), torch.sin(ang)], dim=-1)


def _capacity(t: int, frac: float) -> int:
    return min(max(int(math.ceil(t * frac)), 1), t)


def _sparsified(scores: torch.Tensor, tau: float) -> torch.Tensor:
    """True where a block is dropped: its ascending cumulative mass stays
    within ``tau`` of the total (ties in index order)."""
    order = torch.argsort(scores, dim=-1, stable=True)
    cum = torch.cumsum(torch.gather(scores, -1, order), dim=-1)
    picked = cum <= tau * scores.sum(-1, keepdim=True)
    return torch.zeros_like(picked).scatter_(-1, order, picked)


def _keep_top(mask: torch.Tensor, score: torch.Tensor, cap: int) -> torch.Tensor:
    """``mask`` with at most ``cap`` True entries on the last axis: the
    highest scores, the lower index first on a tie."""
    if cap >= mask.shape[-1]:
        return mask
    s = torch.where(mask, score.float(), torch.tensor(float("-inf"), device=mask.device))
    ids = torch.argsort(-s, dim=-1, stable=True)[..., :cap]
    return mask & torch.zeros_like(mask).scatter_(-1, ids, True)


class _Layer:
    """One layer's state between steps."""

    def __init__(self):
        self.m_c = None        # (B, H, T) live (row, head) after the row clamp
        self.m_s = None        # (B, H, T, T) live (row, kv) pairs
        self.d0 = None         # cache bias at the last Update
        self.d1 = None         # its difference from the Update before
        self.updates = 0
        self.k_since = 0


class Reference:
    """A request's steps by the plain rules of the configuration ``cfg`` (the
    configuration file's dict) on the weights ``params`` (the program's
    layout: block leaves stacked ``(L, ...)``)."""

    def __init__(self, cfg: dict, params: dict, *, dtype=torch.bfloat16,
                 rnd: Optional[Callable] = None):
        self.cfg, self.p, self.dtype = cfg, params, dtype
        self.rnd = rnd or (lambda t: t)
        e = cfg["engine"]
        if e["cache_mode"] != "bias" or e["order"] != 1 or e.get("kv_buckets", 1) != 1:
            raise ValueError("the reference covers the bias cache of order 1 on the "
                             "uniform layout")
        self.e = e
        self.table = strategy_table(cfg)

    # -- matmuls and attention ------------------------------------------
    def mm(self, a, w):
        return self.rnd(a) @ self.rnd(w.to(self.dtype))

    def attend(self, q, k, v, mask=None):
        return F.scaled_dot_product_attention(self.rnd(q), self.rnd(k), self.rnd(v),
                                              attn_mask=mask)

    # -- symbols -----------------------------------------------------------
    def symbols(self, q, k, layer: int, n_text: int):
        """(m_c, m_s, q_scores) of every head at pool granularity."""
        e = self.e
        pool = e["pool"]
        b, h, n, hd = q.shape
        t = n // pool
        n_t = -(-n_text // pool)
        qc = q.float().reshape(b, h, t, pool, hd).mean(3)
        kc = k.float().reshape(b, h, t, pool, hd).mean(3)
        p_map = torch.softmax(qc @ kc.transpose(-1, -2) * hd ** -0.5, dim=-1)
        idx = torch.arange(t, device=q.device)
        is_text = idx < n_t
        protect = is_text[:, None] | is_text[None, :]
        rules = self.table[layer]
        m_c = torch.ones((b, h, t), dtype=torch.bool, device=q.device)
        m_s = torch.ones((b, h, t, t), dtype=torch.bool, device=q.device)
        q_sc = torch.ones((b, h, t), device=q.device)
        kv_sc = torch.ones((b, h, t, t), device=q.device)
        for rule in set(rules):
            hs = [i for i, r in enumerate(rules) if r == rule]
            pm = p_map[:, hs]
            if rule in ("flashomni", "skip-only"):
                m_s[:, hs] = ~_sparsified(pm, e["tau_kv"]) | protect
                q_sc[:, hs] = pm.sum(-2)
                kv_sc[:, hs] = pm
            if rule == "flashomni":
                contrib = pm[..., :n_t, n_t:].sum(-2)
                guidance = torch.softmax(pm[..., n_t:, :n_t].transpose(-1, -2), -1).sum(-2)
                cached = _sparsified(contrib, e["tau_q"]) & _sparsified(guidance, e["tau_q"])
                mc = torch.cat([torch.ones_like(cached[..., :n_t]), ~cached], -1)
                degraded = mc.float().mean(-1, keepdim=True) < e["degrade"]
                m_c[:, hs] = mc & ~degraded
            elif rule == "sliding-window":
                dist = (idx[:, None] - idx[None, :]).abs()
                band = (dist < self.cfg["layer_strategies"]["window"]) | protect
                m_s[:, hs] = band
                kv_sc[:, hs] = torch.where(protect, 1e9, -dist.float())
            elif rule != "skip-only":
                raise ValueError(f"the reference has no rule {rule!r}")
        m_c = _keep_top(m_c, q_sc, _capacity(t, e["cap_q_frac"]))
        m_s = _keep_top(m_s, kv_sc, _capacity(t, e["cap_kv_frac"]))
        return m_c, m_s, q_sc

    # -- attention layer ----------------------------------------------------
    def _heads(self, x, w, scale=None):
        b, n, _ = x.shape
        h, hd = self.cfg["n_heads"], self.cfg["head_dim"]
        y = self.mm(x, w).reshape(b, n, h, hd).transpose(1, 2)
        return y if scale is None else _rms(y, scale, 1e-6)

    def update(self, st: _Layer, p: dict, xa, layer: int, n_text: int):
        pool, h = self.e["pool"], self.cfg["n_heads"]
        b, n, dm = xa.shape
        q, k = self._heads(xa, p["wq"], p["q_scale"]), self._heads(xa, p["wk"], p["k_scale"])
        v = self._heads(xa, p["wv"])
        o = self.attend(q, k, v)                                        # (B, H, N, dh)
        m_c, m_s, q_sc = self.symbols(q, k, layer, n_text)
        wo = p["wo"]
        out = self.mm(o.transpose(1, 2).reshape(b, n, -1), wo)
        cached = (~m_c).repeat_interleave(pool, -1)[..., :n]          # (B, H, N)
        bias = self.mm((o * cached[..., None].to(o.dtype)).transpose(1, 2).reshape(b, n, -1),
                       wo).to(torch.bfloat16)
        st.d1 = bias - st.d0 if st.updates >= 1 else torch.zeros_like(bias)
        st.d0 = bias
        st.updates += 1
        st.k_since = 0
        row_score = torch.where(m_c, q_sc, 0.0).sum(1)                 # (B, T)
        rows = _keep_top(m_c.any(1), row_score, _capacity(m_c.shape[-1], self.e["cap_q_frac"]))
        st.m_c, st.m_s = m_c & rows[:, None, :], m_s
        return out

    def dispatch(self, st: _Layer, p: dict, xa):
        pool = self.e["pool"]
        b, n, dm = xa.shape
        h = self.cfg["n_heads"]
        st.k_since += 1
        q, k = self._heads(xa, p["wq"], p["q_scale"]), self._heads(xa, p["wk"], p["k_scale"])
        v = self._heads(xa, p["wv"])
        o = torch.zeros_like(q)
        step = max(pool, (_MASK_ELEMS // (h * n)) // pool * pool)
        for r0 in range(0, n, step):
            r1 = min(n, r0 + step)
            rb = slice(r0 // pool, -(-r1 // pool))
            live = st.m_c[:, :, rb]                                     # (B, H, R)
            pairs = st.m_s[:, :, rb] | ~live[..., None]                 # dead rows: any key
            mask = pairs.repeat_interleave(pool, -2).repeat_interleave(pool, -1)
            mask = mask[:, :, : r1 - r0, :n]
            oc = self.attend(q[:, :, r0:r1], k, v, mask)
            live_tok = live.repeat_interleave(pool, -1)[..., : r1 - r0]
            o[:, :, r0:r1] = torch.where(live_tok[..., None], oc, 0)
        coef = float(st.k_since) / float(self.e["interval"])
        bias_f = (st.d0.float() + st.d1.float() * coef).to(xa.dtype)
        return self.mm(o.transpose(1, 2).reshape(b, n, -1), p["wo"]) + bias_f

    # -- the model -----------------------------------------------------------
    def step(self, states: list, x_lat, text, patch_embed, i: int, n_steps: int, mode: str):
        """One Euler step: the latents after step ``i`` of ``n_steps``."""
        c, p, dt = self.cfg, self.p, self.dtype
        eps = c["norm_eps"]
        b = x_lat.shape[0]
        n_text = text.shape[1]
        t = (torch.full((b,), i, dtype=torch.float32, device=x_lat.device) * (1.0 / n_steps)).to(dt)
        x = torch.cat([text.to(dt), (x_lat @ patch_embed).to(dt)], dim=1)
        temb = self.mm(_time_embedding(t * 1000.0).to(dt), p["t_mlp1"])
        temb = self.mm(F.silu(temb), p["t_mlp2"]).to(dt)
        ones = torch.ones((c["d_model"],), device=x.device)
        blocks = p["blocks"]
        for li in range(c["n_layers"]):
            bp = {key: val[li] for key, val in blocks.items()}
            mod = self.mm(F.silu(temb), bp["adaln"]) + bp["adaln_b"].to(dt)
            sh_a, sc_a, g_a, sh_m, sc_m, g_m = mod.chunk(6, dim=-1)
            xa = _modulate(_rms(x, ones, eps), sh_a, sc_a)
            if mode == "update":
                o = self.update(states[li], bp, xa, li, n_text)
            else:
                o = self.dispatch(states[li], bp, xa)
            x = x + g_a[:, None] * o.to(dt)
            xm = _modulate(_rms(x, ones, eps), sh_m, sc_m)
            y = self.mm(F.gelu(self.mm(xm, bp["mlp_wi"]), approximate="tanh"), bp["mlp_wo"])
            x = x + g_m[:, None] * y
        sh, sc = self.mm(F.silu(temb), p["final_mod"]).chunk(2, dim=-1)
        x = _modulate(_rms(x, p["final_norm"], eps), sh, sc)
        v = self.mm(x[:, n_text:], p["final_proj"])
        return x_lat + v.to(x_lat.dtype) * (1.0 / n_steps)

    def run(self, x0, text, patch_embed, n_steps: int, upto: int, each=None):
        """Steps ``0 .. upto-1`` of an ``n_steps``-step request from ``x0``;
        ``each(i, latents)`` sees the latents after every step.  Returns
        the last latents."""
        e = self.e
        modes = step_modes(n_steps, e["warmup_steps"], e["interval"])
        states = [_Layer() for _ in range(self.cfg["n_layers"])]
        x = x0
        for i in range(upto):
            with torch.no_grad():
                x = self.step(states, x, text, patch_embed, i, n_steps, modes[i])
            if each is not None:
                each(i, x)
        return x
