"""TaylorSeer feature forecasting, port of ``repro.core.taylorseer``.

At every Update the engine stores the fresh feature and refreshes backward
finite differences up to order 𝒟 (``Δⁱy_t = Δ^{i-1}y_t − Δ^{i-1}y_{t−𝒩}``);
at Dispatch offset ``k`` the forecast is ``Σ_i c_i(k) Δⁱy_t``.  Orders
without enough history are zero, so warmup is exact plain reuse.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = ["TaylorState", "init_state", "update", "forecast", "reuse_coefficients"]


class TaylorState(NamedTuple):
    """Finite-difference stack ``derivs[i] = Δⁱ y`` at the last update."""

    derivs: torch.Tensor   # (order+1, *feature_shape)
    n_updates: int         # updates absorbed so far


def init_state(feature_shape: tuple[int, ...], order: int, dtype=torch.float32,
               device="cpu") -> TaylorState:
    return TaylorState(
        derivs=torch.zeros((order + 1, *feature_shape), dtype=dtype, device=device),
        n_updates=0)


def update(state: TaylorState, y: torch.Tensor) -> TaylorState:
    """Absorb a freshly computed feature at an Update step."""
    order = state.derivs.shape[0] - 1
    prev = state.derivs
    new = [y.to(prev.dtype)]
    for i in range(1, order + 1):
        new.append(new[i - 1] - prev[i - 1])
    n = state.n_updates + 1
    # Order-i differences need i+1 samples; the rest stay zero.
    for i in range(n, order + 1):
        new[i] = torch.zeros_like(new[i])
    return TaylorState(derivs=torch.stack(new, dim=0), n_updates=n)


def reuse_coefficients(order: int, k: int, interval: int,
                       mode: str = "taylor") -> torch.Tensor:
    """f32 coefficients ``c_i`` for offset ``k`` (computed in f32 on the host).

    ``"taylor"``: ``c_i = kⁱ / (i!·𝒩ⁱ)``; ``"newton"``: ``c_i =
    x(x+1)…(x+i−1)/i!`` with ``x = k/𝒩`` (exact for degree ≤ order).
    """
    x = torch.tensor(k, dtype=torch.float32) / float(interval)
    coeffs = []
    c = torch.tensor(1.0, dtype=torch.float32)
    for i in range(order + 1):
        coeffs.append(c)
        if mode == "taylor":
            c = c * x / (i + 1)
        elif mode == "newton":
            c = c * (x + i) / (i + 1)
        else:
            raise ValueError(f"unknown reuse mode: {mode}")
    return torch.stack(coeffs)


def forecast(state: TaylorState, k: int, interval: int,
             mode: str = "taylor") -> torch.Tensor:
    """f32 forecast of the feature ``k`` steps after the last update (OP_reuse)."""
    coef = reuse_coefficients(state.derivs.shape[0] - 1, k, interval, mode)
    coef = coef.tolist()
    out = state.derivs[0].to(torch.float32) * coef[0]
    for i in range(1, len(coef)):
        out.add_(state.derivs[i].to(torch.float32), alpha=coef[i])
    return out
