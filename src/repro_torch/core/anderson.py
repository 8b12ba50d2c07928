"""Anderson acceleration window with the paper's dynamic-m adjustment
(counterpart of ``repro.core.anderson``).

Algorithm 1 lines 16-19:

    theta* = argmin || F^t - sum_j theta_j (F^{t-j+1} - F^{t-j}) ||^2
    C^{t+1} = G^t  -  sum_j theta_j* (G^{t-j+1} - G^{t-j})

with the minus sign of the classical type-II update (the paper's Eq. 8
prints a "+"; see the reference module).  Every function here works on a
leading batch axis of R independent windows — the JAX package vmaps the
unbatched functions; the port writes the axis out.  State lives in
fixed-shape circular buffers; the least-squares problem is solved through
its normal equations with a tiny relative ridge, inactive columns masked
by an identity block.

Dynamic m (lines 7-11), r = (E^{t-1} - E^t) / (E^{t-2} - E^{t-1}):
r < eps1 -> m = max(m - 1, 0);  r > eps2 -> m = min(m + 1, mbar).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch


@dataclasses.dataclass(frozen=True)
class AAConfig:
    m0: int = 2            # initial window size
    mbar: int = 30         # maximum window size (paper: 30)
    eps1: float = 0.02     # shrink threshold (paper: 0.02)
    eps2: float = 0.5      # grow threshold (paper: 0.5)
    dynamic_m: bool = True  # False -> fixed m = m0
    ridge: float = 1e-12   # relative Tikhonov regularisation


class AAState(NamedTuple):
    """R fixed-shape Anderson windows.

    dF, dG : (R, mbar, D) circular buffers of residual / iterate
             differences; column ``head - 1 - j (mod mbar)`` holds
             (F^{t-j} - F^{t-j-1}).
    f_prev, g_prev : (R, D) last residual / last fixed-point image.
    ncols  : (R,) int32 number of valid history columns (min(t, mbar)).
    head   : (R,) int32 next write position.
    m      : (R,) int32 current window size.
    """
    dF: torch.Tensor
    dG: torch.Tensor
    f_prev: torch.Tensor
    g_prev: torch.Tensor
    ncols: torch.Tensor
    head: torch.Tensor
    m: torch.Tensor


def aa_init(r: int, d_flat: int, cfg: AAConfig, dtype=torch.float32,
            device=None) -> AAState:
    z = dict(dtype=dtype, device=device)
    i32 = dict(dtype=torch.int32, device=device)
    return AAState(
        dF=torch.zeros((r, cfg.mbar, d_flat), **z),
        dG=torch.zeros((r, cfg.mbar, d_flat), **z),
        f_prev=torch.zeros((r, d_flat), **z),
        g_prev=torch.zeros((r, d_flat), **z),
        ncols=torch.zeros((r,), **i32),
        head=torch.zeros((r,), **i32),
        m=torch.full((r,), cfg.m0, **i32))


def aa_seed(state: AAState, f0: torch.Tensor, g0: torch.Tensor) -> AAState:
    """Record (F^0, G^0) before the first accelerated iteration."""
    return state._replace(f_prev=f0, g_prev=g0)


def adjust_m(state: AAState, e_curr: torch.Tensor, e_prev: torch.Tensor,
             e_prev2: torch.Tensor, cfg: AAConfig) -> AAState:
    """Algorithm 1 lines 7-11, per window.  Guarded for t < 2 (e_prev2 =
    +inf: m unchanged) and for a zero previous decrease (ratio -> +/-inf,
    the limit)."""
    if not cfg.dynamic_m:
        return state
    num = e_prev - e_curr
    den = e_prev2 - e_prev
    tiny = torch.finfo(num.dtype).tiny
    # Python scalars, not a torch.tensor(inf) on the device: building one
    # is a blocking host-to-device copy that would wait for the step.
    ratio = torch.where(den > 0, num / torch.clamp_min(den, tiny),
                        torch.where(num > 0, float("inf"), float("-inf")))
    defined = torch.isfinite(e_prev2)
    shrink = defined & (ratio < cfg.eps1)
    grow = defined & (ratio > cfg.eps2)
    m = torch.where(shrink, torch.clamp_min(state.m - 1, 0),
                    torch.where(grow, torch.clamp_max(state.m + 1, cfg.mbar),
                                state.m))
    return state._replace(m=m.to(torch.int32))


def _spd_solve(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve R (n, n) SPD systems by unpivoted Gauss–Jordan elimination —
    the reference's algorithm, step for step, so the window solve rounds
    the same way (``torch.linalg.solve`` would pivot and factor
    differently).  a (R, n, n), b (R, n) -> (R, n)."""
    n = a.shape[-1]
    aug = torch.cat([a, b[..., None]], dim=-1)            # (R, n, n+1)
    for i in range(n):
        pivot_row = aug[:, i] / aug[:, i, i:i + 1]        # (R, n+1)
        factors = aug[:, :, i]                            # (R, n)
        aug = aug - factors[:, :, None] * pivot_row[:, None, :]
        aug[:, i] = pivot_row
    return aug[:, :, n]


def _column_ages(state: AAState, mbar: int) -> torch.Tensor:
    """age[r, i] = steps since column i of window r was written (1 =
    newest); invalid columns get mbar + 1."""
    idx = torch.arange(mbar, dtype=torch.int32, device=state.head.device)
    age = torch.remainder(state.head[:, None] - 1 - idx, mbar) + 1
    return torch.where(age <= state.ncols[:, None], age, mbar + 1)


def aa_push_and_solve(state: AAState, f: torch.Tensor, g: torch.Tensor,
                      cfg: AAConfig):
    """Push (F^t, G^t), solve over each active window, return C^{t+1}.
    f, g (R, D).  Returns (new_state, c_next_flat (R, D), theta, m_t).
    The input state is not modified."""
    mbar = cfg.mbar
    rows = torch.arange(f.shape[0], device=f.device)
    head = state.head.long()
    dF = state.dF.clone()
    dG = state.dG.clone()
    dF[rows, head] = f - state.f_prev
    dG[rows, head] = g - state.g_prev
    state = state._replace(
        dF=dF, dG=dG, f_prev=f, g_prev=g,
        ncols=torch.clamp_max(state.ncols + 1, mbar),
        head=torch.remainder(state.head + 1, mbar).to(torch.int32))

    m_t = torch.minimum(state.m, state.ncols)             # line 17
    active = _column_ages(state, mbar) <= m_t[:, None]    # (R, mbar)

    # Normal equations over masked columns: (A A^T + lam I) theta = A f
    a_mask = torch.where(active[:, :, None], dF, 0.0)
    gram = a_mask @ a_mask.transpose(1, 2)                # (R, mbar, mbar)
    rhs = (a_mask @ f[:, :, None])[..., 0]                # (R, mbar)
    lam = cfg.ridge * (torch.diagonal(gram, dim1=1, dim2=2).sum(-1) + 1.0)
    eye = torch.eye(mbar, dtype=f.dtype, device=f.device)
    both = active[:, :, None] & active[:, None, :]
    gram = torch.where(both, gram, 0.0) + \
        eye * torch.where(active, lam[:, None], 1.0)[:, :, None]
    theta = torch.where(active, _spd_solve(gram, rhs), 0.0)

    dg_mask = torch.where(active[:, :, None], dG, 0.0)
    c_next = g - (theta[:, None, :] @ dg_mask)[:, 0]      # line 19
    # m_t == 0 -> exactly the plain Lloyd iterate
    c_next = torch.where((m_t > 0)[:, None], c_next, g)
    return state, c_next, theta, m_t
