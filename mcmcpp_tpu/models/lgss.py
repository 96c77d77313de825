"""Linear-Gaussian state space: parallel-in-time Kalman filter, RTS
smoother, exact forward-filter backward-sampling (FFBS), and a blocked-
Gibbs kernel for latent state trajectories.

No reference counterpart (jmatta1/MCMCpp has no time-series layer at all
— its model surface is the user-supplied ``calcLogPostProb`` scalar,
``MCMCpp/EnsembleSampler.h:80-96``); north-star scope, alongside the GP
library in :mod:`mcmcpp_tpu.models.gp`.

Accelerator-native design
-----------------
A Kalman filter is textbook-sequential: T tiny (D, D) solves chained by a
data dependence, the worst possible shape for an accelerator (the matrix units idle while
``lax.scan`` serializes T steps). Both hot paths here are therefore
reformulated as **associative scans** so XLA compiles them to O(log T)
depth of *batched* matmuls:

- the forward filter uses the associative filtering elements of Särkkä &
  García-Fernández (2021), "Temporal Parallelization of Bayesian
  Smoothers" (IEEE TAC 66(1), §III): each step is summarized as a
  five-tuple ``(A, b, C, eta, J)`` and combined with
  ``jax.lax.associative_scan``; the prefix-combined ``(b, C)`` ARE the
  filtered mean/covariance.
- the backward **sampling** pass exploits that, once the per-step
  Gaussian noises are drawn up front, the FFBS recursion
  ``x_t = G_t x_{t+1} + d_t + L_t z_t`` is an affine recurrence — the
  composition of affine maps is associative, so the entire joint draw is
  one reverse ``associative_scan`` over ``(G, d + L z)`` pairs.

Both have sequential ``lax.scan`` twins (``method="sequential"``) used as
the correctness anchor in ``tests/test_lgss.py`` (the parallel paths must
match them to float tolerance) and as the cheaper choice for very small T
or very large D.

Model (time-invariant):

    x_1 ~ N(m1, P1)                       [or x_1 = A x_0 + b + w with
                                           x_0 ~ N(m0, P0): set
                                           ``initial="prior"``]
    x_t = A x_{t-1} + b + w_t,   w_t ~ N(0, Q)     t = 2..T
    y_t = H x_t + c + v_t,       v_t ~ N(0, R)     t = 1..T

``initial="state"`` (default) places the Gaussian directly on the first
*state* — the Durbin & Koopman a1/P1 convention — which keeps the
variance conditionals conjugate in Gibbs schemes (the x_1 factor carries
no Q dependence). ``initial="prior"`` is the Särkkä convention with a
latent pre-sample state x_0.
"""

from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp
from jax.scipy.linalg import cho_factor, cho_solve


class LGSSParams(NamedTuple):
    """Model matrices (shapes: D latent, E observed).

    ANY subset of A/b/Q/H/c/R may carry a leading time axis:

    - ``H`` (T, E, D) / ``c`` (T, E): dynamic regression (H_t = the
      step's covariate row), BSTS with regressors;
    - ``A``/``Q`` (T, D, D), ``b`` (T, D), ``R`` (T, E, E): switching /
      regime-dependent dynamics — e.g. build ``A_t = A[z_t]`` from a
      sampled HMM regime path and alternate :class:`LGSSKernel` with an
      :class:`~mcmcpp_tpu.models.hmm.HMMKernel` block (switching SSM).

    Convention: ``A_t/b_t/Q_t`` govern the transition INTO step t
    (index 0 only used by ``initial="prior"``); ``H_t/c_t/R_t`` observe
    step t. The backward passes (RTS, FFBS) consume per-step A/b/Q but
    never H, so smoothing and exact trajectory draws work unchanged.
    """

    A: jnp.ndarray   # (D, D) transition — or (T, D, D) time-varying
    b: jnp.ndarray   # (D,)   transition offset — or (T, D)
    Q: jnp.ndarray   # (D, D) transition noise covariance — or (T, D, D)
    H: jnp.ndarray   # (E, D) observation — or (T, E, D)
    c: jnp.ndarray   # (E,)   observation offset — or (T, E)
    R: jnp.ndarray   # (E, E) observation noise covariance — or (T, E, E)
    m0: jnp.ndarray  # (D,)   initial mean (of x_1 or x_0 — see `initial`)
    P0: jnp.ndarray  # (D, D) initial covariance


def _is_tv(p: LGSSParams):
    return (p.H.ndim == 3 or p.A.ndim == 3 or p.Q.ndim == 3
            or p.R.ndim == 3 or p.b.ndim == 2 or p.c.ndim == 2)


def _tv_view(p: LGSSParams, t_n):
    """Broadcast every matrix to a leading time axis for the tv paths:
    (As (T,D,D), bs (T,D), Qs (T,D,D), Hs (T,E,D), cs (T,E),
    Rs (T,E,E)). Convention: ``As[k]/bs[k]/Qs[k]`` govern the transition
    INTO step k (so index 0 is used only by ``initial="prior"``);
    ``Hs[k]/cs[k]/Rs[k]`` observe step k.
    """
    d = p.A.shape[-1]
    e = p.H.shape[-2]

    def bc(x, shape, name):
        x = jnp.asarray(x)
        if x.ndim == len(shape) - 1:
            return jnp.broadcast_to(x, (t_n,) + x.shape)
        if x.shape != (t_n,) + shape[1:]:
            raise ValueError(
                f"time-varying {name} has shape {x.shape}; expected "
                f"{shape[1:]} or {(t_n,) + shape[1:]} (ys has T={t_n})"
            )
        return x

    return (
        bc(p.A, (t_n, d, d), "A"), bc(p.b, (t_n, d), "b"),
        bc(p.Q, (t_n, d, d), "Q"), bc(p.H, (t_n, e, d), "H"),
        bc(p.c, (t_n, e), "c"), bc(p.R, (t_n, e, e), "R"),
    )


def lgss_params(A, b, Q, H, c, R, m0, P0, dtype=jnp.float32):
    """Build :class:`LGSSParams`, promoting scalars/1-D shorthands.

    Any of A/b/Q/H/c/R may carry a leading time axis (see
    :class:`LGSSParams`) — three-axis matrices / two-axis vectors are
    passed through as time-varying.
    """
    A = jnp.asarray(A, dtype)
    if A.ndim < 2:
        A = jnp.atleast_2d(A)
    d = A.shape[-1]
    Q = jnp.asarray(Q, dtype)
    Q = Q * jnp.eye(d, dtype=dtype) if Q.ndim == 0 else Q
    if Q.ndim == 1:
        Q = jnp.atleast_2d(Q)
    H = jnp.asarray(H, dtype)
    if H.ndim < 2:
        H = jnp.atleast_2d(H)
    e = H.shape[-2]
    R = jnp.asarray(R, dtype)
    R = R * jnp.eye(e, dtype=dtype) if R.ndim == 0 else R
    if R.ndim == 1:
        R = jnp.atleast_2d(R)
    P0 = jnp.asarray(P0, dtype)
    P0 = P0 * jnp.eye(d, dtype=dtype) if P0.ndim == 0 else jnp.atleast_2d(P0)
    b = jnp.asarray(b, dtype)
    if b.ndim < 2:
        b = jnp.broadcast_to(b, (d,))
    c = jnp.asarray(c, dtype)
    if c.ndim < 2:
        c = jnp.broadcast_to(c, (e,))
    return LGSSParams(
        A=A,
        b=b,
        Q=Q,
        H=H,
        c=c,
        R=R,
        m0=jnp.broadcast_to(jnp.asarray(m0, dtype), (d,)),
        P0=P0,
    )


class FilterResult(NamedTuple):
    means: jnp.ndarray   # (T, D) filtered E[x_t | y_{1:t}]
    covs: jnp.ndarray    # (T, D, D)
    loglik: jnp.ndarray  # scalar log p(y_{1:T})


def _first_pred(p: LGSSParams, initial: str):
    """Predictive mean/cov of x_1 before seeing y_1."""
    if initial == "state":
        return p.m0, p.P0
    if initial == "prior":
        return p.A @ p.m0 + p.b, p.A @ p.P0 @ p.A.T + p.Q
    raise ValueError(f"initial must be 'state' or 'prior', got {initial!r}")


def _seq_filter(p: LGSSParams, ys, initial, mask):
    m1p, P1p = _first_pred(p, initial)
    e = p.H.shape[0]
    cst = e * np.log(2.0 * np.pi)

    def measure(mp, Pp, y, obs):
        """Masked update: missing steps keep the predictive moments and
        contribute zero log-likelihood (y arrives NaN-scrubbed)."""
        S = p.H @ Pp @ p.H.T + p.R
        cf = cho_factor(S, lower=True)
        innov = y - p.H @ mp - p.c
        # K = Pp Hᵀ S⁻¹, built as (S⁻¹ H Pp)ᵀ through the Cholesky solve
        K = cho_solve(cf, p.H @ Pp).T
        m = jnp.where(obs, mp + K @ innov, mp)
        P = jnp.where(obs, Pp - K @ (p.H @ Pp), Pp)
        ll = jnp.where(
            obs,
            -0.5 * (
                cst
                + 2.0 * jnp.sum(jnp.log(jnp.diagonal(cf[0])))
                + innov @ cho_solve(cf, innov)
            ),
            0.0,
        )
        return m, P, ll

    m1, P1, ll1 = measure(m1p, P1p, ys[0], mask[0])

    def step(carry, inp):
        y, obs = inp
        m, P = carry
        mp = p.A @ m + p.b
        Pp = p.A @ P @ p.A.T + p.Q
        m, P, ll = measure(mp, Pp, y, obs)
        return (m, P), (m, P, ll)

    (_, _), (ms, Ps, lls) = jax.lax.scan(step, (m1, P1), (ys[1:], mask[1:]))
    means = jnp.concatenate([m1[None], ms], axis=0)
    covs = jnp.concatenate([P1[None], Ps], axis=0)
    return FilterResult(means, covs, ll1 + jnp.sum(lls))


def _first_pred_tv(p, As, bs, Qs, initial):
    """x_1 predictive under per-step matrices (index 0 = into step 1)."""
    if initial == "state":
        return p.m0, p.P0
    if initial == "prior":
        return (As[0] @ p.m0 + bs[0],
                As[0] @ p.P0 @ As[0].T + Qs[0])
    raise ValueError(f"initial must be 'state' or 'prior', got {initial!r}")


def _seq_filter_tv(p: LGSSParams, ys, initial, mask):
    """Sequential filter with per-step matrices (dynamic regression,
    switching dynamics — any subset of A/b/Q/H/c/R time-varying)."""
    t_n = ys.shape[0]
    As, bs, Qs, Hs, cs, Rs = _tv_view(p, t_n)
    e = Hs.shape[1]
    cst = e * np.log(2.0 * np.pi)
    m1p, P1p = _first_pred_tv(p, As, bs, Qs, initial)

    def measure(mp, Pp, y, obs, h, cc, r):
        S = h @ Pp @ h.T + r
        cf = cho_factor(S, lower=True)
        innov = y - h @ mp - cc
        K = cho_solve(cf, h @ Pp).T
        m = jnp.where(obs, mp + K @ innov, mp)
        P = jnp.where(obs, Pp - K @ (h @ Pp), Pp)
        ll = jnp.where(
            obs,
            -0.5 * (
                cst
                + 2.0 * jnp.sum(jnp.log(jnp.diagonal(cf[0])))
                + innov @ cho_solve(cf, innov)
            ),
            0.0,
        )
        return m, P, ll

    m1, P1, ll1 = measure(m1p, P1p, ys[0], mask[0], Hs[0], cs[0], Rs[0])

    def step(carry, inp):
        y, obs, a, bv, q, h, cc, r = inp
        m, P = carry
        mp = a @ m + bv
        Pp = a @ P @ a.T + q
        m, P, ll = measure(mp, Pp, y, obs, h, cc, r)
        return (m, P), (m, P, ll)

    (_, _), (ms, Ps, lls) = jax.lax.scan(
        step, (m1, P1),
        (ys[1:], mask[1:], As[1:], bs[1:], Qs[1:], Hs[1:], cs[1:], Rs[1:]),
    )
    means = jnp.concatenate([m1[None], ms], axis=0)
    covs = jnp.concatenate([P1[None], Ps], axis=0)
    return FilterResult(means, covs, ll1 + jnp.sum(lls))


class _FilterElem(NamedTuple):
    """Särkkä & García-Fernández (2021) associative filtering element:
    the step-k message p(x_k | y_k, x_{k-1}) parametrized as
    N(x_k; A x_{k-1} + b, C) x exp(x_{k-1}ᵀ η − ½ x_{k-1}ᵀ J x_{k-1})."""

    A: jnp.ndarray
    b: jnp.ndarray
    C: jnp.ndarray
    eta: jnp.ndarray
    J: jnp.ndarray


def _combine_filter(e1: _FilterElem, e2: _FilterElem):
    """Associative combination (ibid., Lemma 8) — all inverses realized
    as solves against I + C₁J₂ / I + J₂C₁ (products of PSD matrices, so
    well-conditioned)."""
    d = e1.A.shape[-1]
    eye = jnp.eye(d, dtype=e1.A.dtype)

    def one(a1, a2):
        IpCJ = eye + a1.C @ a2.J
        IpJC = eye + a2.J @ a1.C
        A2s = jnp.linalg.solve(IpCJ.T, a2.A.T).T  # A₂ (I + C₁J₂)⁻¹
        A = A2s @ a1.A
        b = A2s @ (a1.b + a1.C @ a2.eta) + a2.b
        C = A2s @ a1.C @ a2.A.T + a2.C
        A1s = jnp.linalg.solve(IpJC.T, a1.A).T    # A₁ᵀ (I + J₂C₁)⁻¹
        eta = A1s @ (a2.eta - a2.J @ a1.b) + a1.eta
        J = A1s @ a2.J @ a1.A + a1.J
        return _FilterElem(A, b, C, eta, J)

    # leading time axis is batched by associative_scan
    return jax.vmap(one)(e1, e2)


def _parallel_filter(p: LGSSParams, ys, initial, mask):
    t_n, e = ys.shape[0], p.H.shape[0]
    d = p.A.shape[0]
    dt = ys.dtype

    # generic element (k >= 2): prediction covariance is Q
    S = p.H @ p.Q @ p.H.T + p.R
    cf = cho_factor(S, lower=True)
    K = cho_solve(cf, p.H @ p.Q).T            # Q Hᵀ S⁻¹
    ImKH = jnp.eye(d, dtype=dt) - K @ p.H
    HtSinv = cho_solve(cf, p.H).T             # Hᵀ S⁻¹
    resid = ys - p.H @ p.b - p.c              # (T, E): y_k − H b − c
    A_g = jnp.broadcast_to(ImKH @ p.A, (t_n, d, d))
    b_g = p.b + resid @ K.T                   # (T, D)
    C_g = jnp.broadcast_to(ImKH @ p.Q, (t_n, d, d))
    eta_g = resid @ (p.A.T @ HtSinv).T        # (T, D)
    J_g = jnp.broadcast_to(p.A.T @ HtSinv @ p.H @ p.A, (t_n, d, d))

    # a MISSING step contributes the pure prediction element
    # (A, b, Q, 0, 0) — conditioning on nothing
    m3 = mask[:, None, None]
    m2 = mask[:, None]
    A_g = jnp.where(m3, A_g, jnp.broadcast_to(p.A, (t_n, d, d)))
    b_g = jnp.where(m2, b_g, jnp.broadcast_to(p.b, (t_n, d)))
    C_g = jnp.where(m3, C_g, jnp.broadcast_to(p.Q, (t_n, d, d)))
    eta_g = jnp.where(m2, eta_g, jnp.zeros((t_n, d), dt))
    J_g = jnp.where(m3, J_g, jnp.zeros((t_n, d, d), dt))

    # element 1 conditions on the initial distribution, not on x_0
    m1p, P1p = _first_pred(p, initial)
    S1 = p.H @ P1p @ p.H.T + p.R
    cf1 = cho_factor(S1, lower=True)
    K1 = cho_solve(cf1, p.H @ P1p).T
    b_1 = jnp.where(
        mask[0], m1p + K1 @ (ys[0] - p.H @ m1p - p.c), m1p
    )
    C_1 = jnp.where(mask[0], P1p - K1 @ (p.H @ P1p), P1p)
    zero_d = jnp.zeros((d, d), dt)

    elems = _FilterElem(
        A=A_g.at[0].set(zero_d),
        b=b_g.at[0].set(b_1),
        C=C_g.at[0].set(C_1),
        eta=eta_g.at[0].set(jnp.zeros(d, dt)),
        J=J_g.at[0].set(zero_d),
    )
    pref = jax.lax.associative_scan(_combine_filter, elems)
    means, covs = pref.b, pref.C

    # log-likelihood from the one-step predictives, batched over T (the
    # filtered m_{k-1}, P_{k-1} are already available from the scan)
    m_prev = jnp.concatenate([jnp.zeros((1, d), dt), means[:-1]], axis=0)
    P_prev = jnp.concatenate([jnp.zeros((1, d, d), dt), covs[:-1]], axis=0)
    m_pred = m_prev @ p.A.T + p.b
    P_pred = jnp.einsum("ij,tjk,lk->til", p.A, P_prev, p.A) + p.Q
    m_pred = m_pred.at[0].set(m1p)
    P_pred = P_pred.at[0].set(P1p)
    S_all = jnp.einsum("ij,tjk,lk->til", p.H, P_pred, p.H) + p.R
    innov = ys - m_pred @ p.H.T - p.c

    def one_ll(Sk, ik):
        cfk = cho_factor(Sk, lower=True)
        return -0.5 * (
            e * np.log(2.0 * np.pi)
            + 2.0 * jnp.sum(jnp.log(jnp.diagonal(cfk[0])))
            + ik @ cho_solve(cfk, ik)
        )

    loglik = jnp.sum(jnp.where(mask, jax.vmap(one_ll)(S_all, innov), 0.0))
    return FilterResult(means, covs, loglik)


def _parallel_filter_tv(p: LGSSParams, ys, initial, mask):
    """Associative-scan filter with per-step matrices: the Särkkä &
    García-Fernández elements are per-step constructions anyway, so the
    time-varying case just builds them with a vmap over t instead of a
    broadcast. Any subset of A/b/Q/H/c/R may carry a time axis."""
    t_n = ys.shape[0]
    As, bs, Qs, Hs, cs, Rs = _tv_view(p, t_n)
    e = Hs.shape[1]
    d = As.shape[-1]
    dt = ys.dtype

    def generic(a, bv, q, h, cc, r, y):
        S = h @ q @ h.T + r
        cf = cho_factor(S, lower=True)
        K = cho_solve(cf, h @ q).T
        ImKH = jnp.eye(d, dtype=dt) - K @ h
        HtSinv = cho_solve(cf, h).T
        resid = y - h @ bv - cc
        return (
            ImKH @ a,
            bv + K @ resid,
            ImKH @ q,
            (a.T @ HtSinv) @ resid,
            a.T @ HtSinv @ h @ a,
        )

    A_g, b_g, C_g, eta_g, J_g = jax.vmap(generic)(
        As, bs, Qs, Hs, cs, Rs, ys
    )

    m3 = mask[:, None, None]
    m2 = mask[:, None]
    A_g = jnp.where(m3, A_g, As)
    b_g = jnp.where(m2, b_g, bs)
    C_g = jnp.where(m3, C_g, Qs)
    eta_g = jnp.where(m2, eta_g, jnp.zeros((t_n, d), dt))
    J_g = jnp.where(m3, J_g, jnp.zeros((t_n, d, d), dt))

    m1p, P1p = _first_pred_tv(p, As, bs, Qs, initial)
    S1 = Hs[0] @ P1p @ Hs[0].T + Rs[0]
    cf1 = cho_factor(S1, lower=True)
    K1 = cho_solve(cf1, Hs[0] @ P1p).T
    b_1 = jnp.where(
        mask[0], m1p + K1 @ (ys[0] - Hs[0] @ m1p - cs[0]), m1p
    )
    C_1 = jnp.where(mask[0], P1p - K1 @ (Hs[0] @ P1p), P1p)
    zero_d = jnp.zeros((d, d), dt)

    elems = _FilterElem(
        A=A_g.at[0].set(zero_d),
        b=b_g.at[0].set(b_1),
        C=C_g.at[0].set(C_1),
        eta=eta_g.at[0].set(jnp.zeros(d, dt)),
        J=J_g.at[0].set(zero_d),
    )
    pref = jax.lax.associative_scan(_combine_filter, elems)
    means, covs = pref.b, pref.C

    m_prev = jnp.concatenate([jnp.zeros((1, d), dt), means[:-1]], axis=0)
    P_prev = jnp.concatenate([jnp.zeros((1, d, d), dt), covs[:-1]], axis=0)
    m_pred = jnp.einsum("tij,tj->ti", As, m_prev) + bs
    P_pred = jnp.einsum("tij,tjk,tlk->til", As, P_prev, As) + Qs
    m_pred = m_pred.at[0].set(m1p)
    P_pred = P_pred.at[0].set(P1p)
    S_all = jnp.einsum("tij,tjk,tlk->til", Hs, P_pred, Hs) + Rs
    innov = ys - jnp.einsum("tij,tj->ti", Hs, m_pred) - cs

    def one_ll(Sk, ik):
        cfk = cho_factor(Sk, lower=True)
        return -0.5 * (
            e * np.log(2.0 * np.pi)
            + 2.0 * jnp.sum(jnp.log(jnp.diagonal(cfk[0])))
            + ik @ cho_solve(cfk, ik)
        )

    loglik = jnp.sum(jnp.where(mask, jax.vmap(one_ll)(S_all, innov), 0.0))
    return FilterResult(means, covs, loglik)


def kalman_filter(params: LGSSParams, ys, method="parallel",
                  initial="state", mask=None):
    """Filtered means/covariances and the marginal log-likelihood.

    ys: (T, E) observations. ``method="parallel"`` is the
    associative-scan path (O(log T) depth); ``"sequential"`` the classic
    ``lax.scan`` (the two agree to float tolerance — tested).

    Missing observations: pass ``mask`` ((T,) bool, True = observed), or
    just leave NaNs in ``ys`` — rows with any non-finite entry are
    treated as missing (skipped update, zero likelihood contribution,
    moments coast on the prediction step). Partially observed VECTOR
    rows are all-or-nothing here; model per-component gaps as separate
    scalar series or inflate R on the missing components."""
    ys = jnp.asarray(ys, params.A.dtype)
    if ys.ndim == 1:
        ys = ys[:, None]
    if mask is None:
        mask = jnp.all(jnp.isfinite(ys), axis=1)
    else:
        mask = jnp.asarray(mask, bool)
        if mask.shape != (ys.shape[0],):
            raise ValueError(f"mask must be ({ys.shape[0]},)")
    # scrub NaNs so masked arithmetic can't poison the observed path
    ys = jnp.where(mask[:, None], jnp.where(jnp.isfinite(ys), ys, 0.0), 0.0)
    tv = _is_tv(params)
    if method == "parallel":
        return (_parallel_filter_tv if tv else _parallel_filter)(
            params, ys, initial, mask
        )
    if method == "sequential":
        return (_seq_filter_tv if tv else _seq_filter)(
            params, ys, initial, mask
        )
    raise ValueError(f"method must be 'parallel'|'sequential', got {method!r}")


def lgss_loglik(params: LGSSParams, ys, method="parallel",
                initial="state", mask=None):
    """Marginal log p(y_obs) with the states integrated out — the
    collapsed target for sampling hyperparameters WITHOUT a latent block
    (pair with any gradient engine; this whole module is differentiable).
    ``mask``/NaN rows as in :func:`kalman_filter`."""
    return kalman_filter(params, ys, method=method, initial=initial,
                         mask=mask).loglik


def rts_smoother(params: LGSSParams, ys=None, filtered: FilterResult = None,
                 method="parallel", initial="state", mask=None):
    """Rauch–Tung–Striebel smoothed means/covs (T, D) / (T, D, D).

    The backward pass is a short sequential scan (the FFBS draw below is
    the parallel-in-time path; the smoother is kept simple as the
    diagnostic/oracle tool)."""
    if filtered is None:
        filtered = kalman_filter(params, ys, method=method, initial=initial,
                                 mask=mask)
    p = params
    ms, Ps = filtered.means, filtered.covs
    t_n = ms.shape[0]
    # the transition from t to t+1 uses the step-(t+1) matrices
    As, bs, Qs, _, _, _ = _tv_view(p, t_n)

    def step(carry, inp):
        ms_next, Ps_next = carry
        m, P, a, bv, q = inp
        Pp = a @ P @ a.T + q
        G = jnp.linalg.solve(Pp, a @ P).T  # P Aᵀ Pp⁻¹
        m_s = m + G @ (ms_next - a @ m - bv)
        P_s = P + G @ (Ps_next - Pp) @ G.T
        return (m_s, P_s), (m_s, P_s)

    (_, _), (ms_s, Ps_s) = jax.lax.scan(
        step, (ms[-1], Ps[-1]),
        (ms[:-1], Ps[:-1], As[1:], bs[1:], Qs[1:]), reverse=True
    )
    means = jnp.concatenate([ms_s, ms[-1][None]], axis=0)
    covs = jnp.concatenate([Ps_s, Ps[-1][None]], axis=0)
    return means, covs


def ffbs_sample(key, params: LGSSParams, ys=None,
                filtered: FilterResult = None, method="parallel",
                initial="state", jitter=0.0, mask=None):
    """One EXACT joint draw x_{1:T} ~ p(x | y) (Carter & Kohn 1994 /
    Frühwirth-Schnatter 1994), shape (T, D).

    Parallel-in-time: with the noises z_t drawn up front, the backward
    recursion ``x_t = G_t x_{t+1} + d_t + L_t z_t`` is an affine
    recurrence, and affine-map composition is associative — so the draw
    is one reverse ``associative_scan`` over (G, d + L z) pairs: O(log T)
    depth of batched (D, D) matmuls instead of a T-step chain.
    ``method="sequential"`` runs the textbook reverse scan instead.

    ``jitter`` adds a diagonal nugget before the conditional Choleskys
    (needed only for exactly-singular Q directions).
    """
    if filtered is None:
        filtered = kalman_filter(params, ys, method=method, initial=initial,
                                 mask=mask)
    p = params
    ms, Ps = filtered.means, filtered.covs
    t_n, d = ms.shape
    dt = ms.dtype
    eye_j = jitter * jnp.eye(d, dtype=dt)

    # the t -> t+1 transition uses the step-(t+1) matrices (identical
    # broadcast views in the time-invariant case)
    As, bs, Qs, _, _, _ = _tv_view(p, t_n)

    # per-step conditional x_t | x_{t+1}, y_{1:t} = N(G x_{t+1} + d_t, Σ_t)
    def gains(m, P, a, bv, q):
        Pp = a @ P @ a.T + q
        G = jnp.linalg.solve(Pp, a @ P).T
        cond_cov = P - G @ (a @ P)
        dvec = m - G @ (a @ m + bv)
        L = jnp.linalg.cholesky(cond_cov + eye_j)
        return G, dvec, L

    Gs, dvecs, Ls = jax.vmap(gains)(
        ms[:-1], Ps[:-1], As[1:], bs[1:], Qs[1:]
    )  # (T-1, ...)
    z = jax.random.normal(key, (t_n, d), dt)
    L_T = jnp.linalg.cholesky(Ps[-1] + eye_j)
    x_T = ms[-1] + L_T @ z[-1]
    u = dvecs + jnp.einsum("tij,tj->ti", Ls, z[:-1])   # (T-1, D)

    if method == "sequential":
        def step(x_next, Gu):
            G, ut = Gu
            x = G @ x_next + ut
            return x, x

        _, xs = jax.lax.scan(step, x_T, (Gs, u), reverse=True)
        return jnp.concatenate([xs, x_T[None]], axis=0)

    # associative scan over affine maps f_t(x) = G_t x + u_t: state t is
    # f_t ∘ f_{t+1} ∘ … ∘ f_{T-1} applied to x_T. Flip to prefix order
    # (g_j = f_{T-1-j}, innermost first) so the combine's argument
    # convention is unambiguous: combine(a, b) = b ∘ a (a is the
    # already-accumulated inner composition, b the newly-added outer map).
    def combine(a, bb):
        Fa, ua = a
        Fb, ub = bb
        return (jnp.einsum("tij,tjk->tik", Fb, Fa),
                jnp.einsum("tij,tj->ti", Fb, ua) + ub)

    F_c, u_c = jax.lax.associative_scan(combine, (Gs[::-1], u[::-1]))
    xs = (jnp.einsum("tij,j->ti", F_c, x_T) + u_c)[::-1]
    return jnp.concatenate([xs, x_T[None]], axis=0)


def forecast(params: LGSSParams, ys=None, filtered: FilterResult = None,
             horizon=1, method="parallel", initial="state", mask=None):
    """k-step-ahead predictive moments from the filtered endpoint.

    Returns ``(state_means (h, D), state_covs (h, D, D),
    obs_means (h, E), obs_covs (h, E, E))`` for horizons 1..h — the
    exact Gaussian forecast distribution p(x_{T+k} | y_{1:T}) and
    p(y_{T+k} | y_{1:T})."""
    if _is_tv(params):
        raise ValueError(
            "forecast() needs observation matrices for FUTURE steps, "
            "which a (T, E, D) time-varying H does not carry. Forecast a "
            "dynamic-regression model by filtering with the horizon "
            "appended: extend H with the future covariate rows, append "
            "NaN rows to ys (mask=False) — the filter coasts on "
            "prediction steps, so the filtered moments AT those rows are "
            "exactly p(x_{T+k} | y_{1:T})."
        )
    if filtered is None:
        filtered = kalman_filter(params, ys, method=method, initial=initial,
                                 mask=mask)
    p = params

    def step(mP, _):
        m, P = mP
        m = p.A @ m + p.b
        P = p.A @ P @ p.A.T + p.Q
        return (m, P), (m, P)

    (_, _), (ms, Ps) = jax.lax.scan(
        step, (filtered.means[-1], filtered.covs[-1]), None,
        length=int(horizon),
    )
    obs_m = ms @ p.H.T + p.c
    obs_P = jnp.einsum("ij,tjk,lk->til", p.H, Ps, p.H) + p.R
    return ms, Ps, obs_m, obs_P


class Component(NamedTuple):
    """One structural block: transition ``A`` (d, d), innovation
    covariance ``Q`` (d, d), observation row ``h`` (d,)."""

    A: jnp.ndarray
    Q: jnp.ndarray
    h: jnp.ndarray


def local_level(sigma_level=1.0, dtype=jnp.float32):
    """Random-walk level: x_{t+1} = x_t + N(0, sigma_level^2)."""
    s = jnp.asarray(sigma_level, dtype)
    return Component(
        A=jnp.eye(1, dtype=dtype),
        Q=(s * s).reshape(1, 1),
        h=jnp.ones((1,), dtype),
    )


def local_linear_trend(sigma_level=1.0, sigma_slope=0.1,
                       dtype=jnp.float32):
    """Level + slope: level_{t+1} = level_t + slope_t + eps_l,
    slope_{t+1} = slope_t + eps_s."""
    sl = jnp.asarray(sigma_level, dtype)
    ss = jnp.asarray(sigma_slope, dtype)
    return Component(
        A=jnp.asarray([[1.0, 1.0], [0.0, 1.0]], dtype),
        Q=jnp.diag(jnp.stack([sl * sl, ss * ss])),
        h=jnp.asarray([1.0, 0.0], dtype),
    )


def seasonal(n_seasons, sigma=0.0, dtype=jnp.float32):
    """Dummy-variable seasonality with period ``n_seasons``: the S-1
    state entries sum (with the implicit current one) to noise, so
    seasonal effects sum to ~0 over a full period."""
    s = int(n_seasons)
    if s < 2:
        raise ValueError("n_seasons must be >= 2")
    a = jnp.zeros((s - 1, s - 1), dtype)
    a = a.at[0, :].set(-1.0)
    a = a.at[1:, :-1].set(jnp.eye(s - 2, dtype=dtype))
    sg = jnp.asarray(sigma, dtype)
    q = jnp.zeros((s - 1, s - 1), dtype).at[0, 0].set(sg * sg)
    h = jnp.zeros((s - 1,), dtype).at[0].set(1.0)
    return Component(A=a, Q=q, h=h)


def autoregressive(phi, sigma=1.0, dtype=jnp.float32):
    """Stationary AR(1) disturbance component."""
    sg = jnp.asarray(sigma, dtype)
    return Component(
        A=jnp.asarray(phi, dtype).reshape(1, 1),
        Q=(sg * sg).reshape(1, 1),
        h=jnp.ones((1,), dtype),
    )


def structural(components, sigma_obs, m0=None, p0_scale=1e3,
               dtype=jnp.float32):
    """Block-diagonal BSTS-style composition of :class:`Component`s into
    :class:`LGSSParams` (y_t = sum of component observations + N(0,
    sigma_obs^2)). ``m0`` defaults to zeros; ``p0_scale`` sets the
    diffuse diagonal initial covariance. Every entry stays
    differentiable, so component scales can be sampler blocks — pair
    with :func:`lgss_loglik` and any gradient engine, or with
    :class:`LGSSKernel` for exact trajectory draws."""
    components = list(components)
    if not components:
        raise ValueError("need at least one component")
    A = jax.scipy.linalg.block_diag(*[c.A for c in components]).astype(dtype)
    Q = jax.scipy.linalg.block_diag(*[c.Q for c in components]).astype(dtype)
    h = jnp.concatenate([jnp.asarray(c.h, dtype) for c in components])
    d = A.shape[0]
    so = jnp.asarray(sigma_obs, dtype)
    return LGSSParams(
        A=A, b=jnp.zeros((d,), dtype), Q=Q,
        H=h[None, :], c=jnp.zeros((1,), dtype),
        R=(so * so).reshape(1, 1),
        m0=(jnp.zeros((d,), dtype) if m0 is None
            else jnp.broadcast_to(jnp.asarray(m0, dtype), (d,))),
        P0=float(p0_scale) * jnp.eye(d, dtype=dtype),
    )


class LGSSKernel:
    """Blocked-Gibbs kernel drawing a latent state trajectory EXACTLY
    from its full conditional via FFBS (an :class:`ExactGibbsKernel` in
    spirit, with the sample built by filter + backward draw).

    Declare the trajectory as a flat ``(T*D,)`` block::

        BlockedGibbsSampler([
            ("x", T * D, LGSSKernel(ys, params_fn)),
            ("log_sigma", 1, <any kernel>),   # hypers see x via `others`
        ], ...)

    ys: (T, E) observations (fixed data).
    params_fn: :class:`LGSSParams`, or a callable ``others -> LGSSParams``
        so the model matrices track live hyperparameter blocks.
    """

    def __init__(self, ys, params_fn, method="parallel", initial="state",
                 jitter=0.0):
        self.ys = jnp.atleast_2d(jnp.asarray(ys))
        if self.ys.shape[0] == 1 and np.asarray(ys).ndim == 1:
            self.ys = self.ys.T
        self._params = params_fn
        self.method = method
        self.initial = initial
        self.jitter = float(jitter)

    def step(self, key, x, others):
        p = self._params(others) if callable(self._params) else self._params
        draw = ffbs_sample(
            key, p, self.ys, method=self.method, initial=self.initial,
            jitter=self.jitter,
        )
        return draw.reshape(-1).astype(x.dtype)
