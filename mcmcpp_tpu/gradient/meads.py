"""MEADS: tuning-free generalized HMC with cross-fold ensemble adaptation.

Hoffman & Sountsov (2022, AISTATS) "Tuning-Free Generalized Hamiltonian
Monte Carlo". The ensemble of chains is partitioned into ``n_folds``
folds; each fold takes one *generalized* HMC step (Horowitz 1991:
partial momentum refresh, ONE leapfrog step, Metropolis accept with
momentum flip on rejection) whose tuning parameters — per-parameter
preconditioner, step size, refresh rate — are computed from the CURRENT
states of the *previous* fold. Because a fold's parameters never depend
on its own state, each fold's kernel leaves the target invariant exactly
and the composition is valid MCMC from step one: there is no
warmup/sampling phase distinction and no dual-averaging schedule. This
is the ensemble-on-a-chip counterpart of the affine-invariant samplers:
the cross-chain statistics that drive adaptation are batch reductions,
free on an accelerator where the chain axis is just a sharded array dimension.

Parametrization (whitened space, see ``_fold_parameters``):

- preconditioner ``sd``: per-parameter std over the previous fold;
- step size ``eps = step_factor / sqrt(lmax(cov(sd * grad)))`` — the
  largest eigenvalue of the whitened-gradient covariance estimates the
  largest Hessian eigenvalue, so ``eps`` is ~half the stability limit of
  the leapfrog on the stiffest mode (paper §3);
- refresh rate ``delta = clip(2 * eps / sqrt(lmax(cov(q / sd))), ·, 1)``
  — momentum persists for ~``2/delta`` steps, matched to the number of
  steps needed to traverse the SLOWEST whitened mode (underdamped
  Langevin with friction ~ inverse slowest timescale).

Largest eigenvalues come from a fixed-iteration power method on the
centered data matrix (two (C, P) matvecs per iteration — no (P, P)
covariance is ever formed).

Momentum is stored in whitened units, so its N(0, I) invariant is
independent of the (step-varying) preconditioner.

No reference counterpart (the C++ library is gradient-free,
``/root/reference/MCMCpp/Utility/UserOjbectsTest.h:144-151``) —
north-star scope beside HMC/NUTS/ChEES.
"""

from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from mcmcpp_tpu.gradient.hmc import GradientSampler


class MEADSState(NamedTuple):
    position: jax.Array  # (n, P)
    momentum: jax.Array  # (n, P), whitened units
    logp: jax.Array  # (n,)
    grad: jax.Array  # (n, P)


def max_eig_cov(x, n_iter=12):
    """Largest eigenvalue of the sample covariance of ``x`` (C, P).

    Deterministic power iteration on the centered data matrix:
    ``Sigma v = X.T @ (X @ v) / (C - 1)``, O(C·P) per iteration.
    """
    c = x.shape[0]
    xc = x - jnp.mean(x, axis=0)
    denom = jnp.asarray(max(c - 1, 1), x.dtype)

    def matvec(v):
        return (xc.T @ (xc @ v)) / denom

    # fixed full-support start; power iteration then amplifies the top mode
    v0 = jnp.full((x.shape[1],), 1.0 / np.sqrt(x.shape[1]), x.dtype)

    def body(_, v):
        w = matvec(v)
        return w / jnp.maximum(jnp.linalg.norm(w), 1e-30)

    v = jax.lax.fori_loop(0, n_iter, body, v0)
    return jnp.maximum(v @ matvec(v), 0.0)


def _fold_parameters(q, g, step_factor, dtype):
    """Tuning parameters (sd, eps, delta) from one fold's (C, P) states."""
    sd = jnp.maximum(jnp.std(q, axis=0), 1e-8)
    lam_g = max_eig_cov(g * sd)
    eps = step_factor * jax.lax.rsqrt(jnp.maximum(lam_g, 1e-12))
    lam_q = max_eig_cov(q / sd)
    sigma_max = jnp.sqrt(jnp.maximum(lam_q, 1e-12))
    delta = jnp.clip(2.0 * eps / sigma_max, 1e-3, 1.0)
    return sd.astype(dtype), eps.astype(dtype), delta.astype(dtype)


def ghmc_fold_step(batch_lp_grad):
    """One generalized-HMC step for a whole fold (C, P) under fixed
    (sd, eps, delta): partial refresh, one preconditioned leapfrog,
    Metropolis accept with momentum flip on rejection (Horowitz 1991)."""

    def step(key, q, p, lp, g, sd, eps, delta):
        from mcmcpp_tpu.gradient.hmc import DIVERGENCE_THRESHOLD

        k_ref, k_acc = jax.random.split(key)
        xi = jax.random.normal(k_ref, p.shape, p.dtype)
        p = jnp.sqrt(1.0 - delta) * p + jnp.sqrt(delta) * xi
        energy = 0.5 * jnp.sum(p**2, axis=1) - lp  # post-refresh Hamiltonian

        p_half = p + 0.5 * eps * (sd[None, :] * g)
        q_new = q + eps * (sd[None, :] * p_half)
        lp_new, g_new = batch_lp_grad(q_new)
        p_new = p_half + 0.5 * eps * (sd[None, :] * g_new)

        log_ratio = (lp_new - 0.5 * jnp.sum(p_new**2, axis=1)) - (
            lp - 0.5 * jnp.sum(p**2, axis=1)
        )
        log_ratio = jnp.where(jnp.isnan(log_ratio), -jnp.inf, log_ratio)
        diverging = log_ratio < -DIVERGENCE_THRESHOLD
        accept_prob = jnp.minimum(1.0, jnp.exp(log_ratio))
        log_u = -jax.random.exponential(k_acc, lp.shape, q.dtype)
        accept = log_u < log_ratio
        a = accept[:, None]
        q = jnp.where(a, q_new, q)
        p = jnp.where(a, p_new, -p)  # flip on rejection: reversibility
        lp = jnp.where(accept, lp_new, lp)
        g = jnp.where(a, g_new, g)
        return q, p, lp, g, accept_prob, accept, diverging, energy

    return step


class MEADSSampler(GradientSampler):
    """MEADS: no warmup phase — ``warmup(n)`` just runs ``n`` unstored
    burn-in steps (adaptation is continuous and exact throughout).

    ``n_chains`` must split into ``n_folds`` folds of >= 4 chains; more
    chains per fold sharpen the eigenvalue/scale estimates (paper §4
    uses fold sizes in the tens). The chain axis shards over ``mesh``
    like every other sampler; fold statistics lower to mesh reductions.
    """

    needs_mass = False

    def __init__(self, logp_fn, n_chains, n_params, seed=0, n_folds=4,
                 step_factor=0.5, **kwargs):
        self.n_folds = int(n_folds)
        self.step_factor = float(step_factor)
        if int(n_chains) % self.n_folds:
            raise ValueError(
                f"n_chains={n_chains} not divisible by n_folds={self.n_folds}"
            )
        if int(n_chains) // self.n_folds < 4:
            raise ValueError(
                "need >= 4 chains per fold for cross-fold statistics "
                f"(got {int(n_chains) // self.n_folds})"
            )
        super().__init__(logp_fn, n_chains, n_params, seed=seed, **kwargs)

    def _make_kernel(self):
        batch_lp_grad = jax.vmap(jax.value_and_grad(self.logp_fn))
        fold_step = ghmc_fold_step(batch_lp_grad)
        K = self.n_folds
        C = self.n_chains // K
        P = self.n_params
        step_factor = self.step_factor

        def step(key, state: MEADSState):
            q = state.position.reshape(K, C, P)
            p = state.momentum.reshape(K, C, P)
            lp = state.logp.reshape(K, C)
            g = state.grad.reshape(K, C, P)
            keys = jax.random.split(key, K)
            aps, accs, divs, ens = [], [], [], []
            # sequential Gibbs-style sweep: fold k is tuned by fold k-1's
            # CURRENT state (already updated this sweep for k >= 1), so
            # parameters are measurable functions of the complement only
            for k in range(K):
                prev = (k - 1) % K
                sd, eps, delta = _fold_parameters(
                    q[prev], g[prev], step_factor, q.dtype
                )
                qk, pk, lpk, gk, ap, acc, div, en = fold_step(
                    keys[k], q[k], p[k], lp[k], g[k], sd, eps, delta
                )
                q = q.at[k].set(qk)
                p = p.at[k].set(pk)
                lp = lp.at[k].set(lpk)
                g = g.at[k].set(gk)
                aps.append(ap)
                accs.append(acc)
                divs.append(div)
                ens.append(en)
            new = MEADSState(
                q.reshape(K * C, P), p.reshape(K * C, P),
                lp.reshape(K * C), g.reshape(K * C, P),
            )
            return new, (
                jnp.concatenate(aps), jnp.concatenate(accs),
                jnp.concatenate(divs), jnp.concatenate(ens),
            )

        return step

    def _constrain(self, state):
        if self._chain_sharding is None:
            return state
        from mcmcpp_tpu.parallel.mesh import vector_sharding

        vec = vector_sharding(self._chain_sharding)
        c = lambda x: jax.lax.with_sharding_constraint(x, self._chain_sharding)
        v = lambda x: jax.lax.with_sharding_constraint(x, vec)
        return MEADSState(
            c(state.position), c(state.momentum), v(state.logp), c(state.grad)
        )

    def _batched_step(self, kernel):
        def step(key, state, step_size, inv_mass):
            # (step_size, inv_mass) are driver-loop plumbing; MEADS tunes
            # itself from cross-fold statistics every step
            state = self._constrain(state)
            state, (ap, acc, div, en) = kernel(key, state)
            return self._constrain(state), (ap, acc, div, en)

        return step

    def init(self, positions):
        positions = jnp.asarray(positions, self.dtype)
        if positions.shape != (self.n_chains, self.n_params):
            raise ValueError(
                f"positions must be ({self.n_chains}, {self.n_params})"
            )
        if self._chain_sharding is not None:
            positions = jax.device_put(positions, self._chain_sharding)
        lp, g = jax.vmap(jax.value_and_grad(self.logp_fn))(positions)
        self._key, k_mom = jax.random.split(self._key)
        p0 = jax.random.normal(k_mom, positions.shape, self.dtype)
        self.state = MEADSState(positions, p0, lp, g)
        return self

    def warmup(self, n_steps, adapt_mass=None):
        """Burn-in only: run ``n_steps`` unstored transitions. MEADS has
        no adaptation phase to freeze (``adapt_mass`` is accepted for
        API parity and ignored)."""
        if self.state is None:
            raise RuntimeError("call init/init_ball first")
        fn = self._warmup_cache.get(int(n_steps))
        if fn is None:
            fn = jax.jit(
                lambda state, key: self._burn_scan(state, key, int(n_steps))
            )
            self._warmup_cache[int(n_steps)] = fn
        self._key, run_key = jax.random.split(self._key)
        self.state = jax.block_until_ready(fn(self.state, run_key))
        return self

    def _burn_scan(self, state, key, n_steps):
        def body(carry, _):
            state, key = carry
            key, sub = jax.random.split(key)
            state, _ = self._step(sub, state, None, None)
            return (state, key), None

        (state, _), _ = jax.lax.scan(body, (state, key), length=n_steps)
        return state
