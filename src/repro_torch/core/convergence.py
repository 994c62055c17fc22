"""Theorem 1 / Corollary 1 bound calculator (paper §2.2).

Port of ``repro/core/convergence.py`` (plain Python, unchanged): the upper
bound on E[f(w_bar^{(T)})] - f* for smooth strongly-convex losses under
LGC with error feedback, given problem constants.  The bound is positive,
decreasing in T and increasing in H, and equal to the reference's
(tests/test_torch_sharded.py).
"""
from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class ProblemConstants:
    mu: float          # strong convexity
    l_smooth: float    # smoothness L
    g2: float          # G^2 second-moment bound
    sigma2: float      # sigma^2 gradient variance (max over devices)
    b: int             # mini-batch size
    m: int             # number of devices
    gamma: float       # compressor contraction (k/D for Top_k)
    h: int             # max gap H
    w0_dist2: float    # ||w0 - w*||^2


def theorem1_bound(c: ProblemConstants, t_rounds: int) -> float:
    """Eq. (6)-(7h) evaluated literally."""
    mu, L, H = c.mu, c.l_smooth, float(c.h)
    kappa = L / mu
    gamma = max(c.gamma, 1e-6)
    a = max(4 * H / gamma, 32 * kappa, H) * 1.01 + 1.0
    # Lemma 1 constant C (uniform gamma_m = gamma)
    big_c = 4 * a * gamma * (1 - gamma ** 2) / max(a * gamma - 4 * H, 1e-9)
    c1 = 192 * (4 - 2 * gamma) * (1 + big_c / gamma ** 2)
    c2 = 8 * (4 - 2 * gamma) * (1 + big_c / gamma ** 2)
    bigA = c.sigma2 * c.m / (c.b * c.m ** 2)          # sum sigma_m^2 / (b M^2)
    eta_t = 8.0 / (mu * a)                            # eta^(0), the largest
    bigB = ((1.5 * mu + 3 * L)
            * (12 * big_c * c.g2 * H ** 2 / gamma ** 2
               + c1 * eta_t ** 2 * H ** 4 * c.g2)
            + 24 * (1 + c2 * H ** 2) * L * c.g2 * H ** 2)
    s_total = sum((a + t) ** 2 for t in range(t_rounds))  # S >= T^3/3
    bound = (L * a ** 3 / (4 * s_total) * c.w0_dist2
             + 8 * L * t_rounds * (t_rounds + 2 * a) / (mu ** 2 * s_total) * bigA
             + 128 * L * t_rounds / (mu ** 3 * s_total) * bigB)
    return float(bound)


def corollary1_rate(c: ProblemConstants, t_rounds: int) -> float:
    """Asymptotic rate, Eq. (8): O(G^2H^3 / mu^2 gamma^3 T^3) + O(sigma^2/mu^2 bMT) + ..."""
    mu, H, T = c.mu, float(c.h), float(t_rounds)
    gamma = max(c.gamma, 1e-6)
    return float(
        c.g2 * H ** 3 / (mu ** 2 * gamma ** 3 * T ** 3)
        + c.sigma2 / (mu ** 2 * c.b * c.m * T)
        + H * c.sigma2 / (mu ** 2 * c.b * c.m * gamma * T ** 2)
        + c.g2 * (H ** 2 + H ** 4) / (mu ** 3 * gamma ** 2 * T ** 2))
