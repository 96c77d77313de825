"""IF2 iterated filtering: maximum-likelihood θ for state-space models.

Ionides, Nguyen, Atchadé, Stoev & King (2015, PNAS 112:719): run the
particle filter on an AUGMENTED state (x, θ) where every particle
carries its own parameter vector perturbed by a random walk whose scale
σ_m cools geometrically across data passes. Joint (x, θ)-resampling
concentrates the θ-swarm on the maximum-likelihood estimate as σ_m → 0
(the theory is an annealed Bayes map; the swarm approaches a point mass
at the MLE). This is the simulation-based (plug-and-play) alternative to
PMMH when you want a POINT estimate instead of a posterior, and it
completes the particle toolbox (filter / smoother / PMMH / particle
Gibbs / SMC² / forecast all live beside it).

Accelerator shape: the augmented cloud is a pair of arrays (N, D) + (N, P);
one data pass is a single ``lax.scan`` over time (perturb-θ → propagate
→ weight → joint resample, all batched); the M cooling iterations are a
host loop over one jitted pass program. ``mesh=`` shards the particle
axis of both arrays via the shared
:func:`~mcmcpp_tpu.parallel.mesh.particle_constrainer` (the reductions
are the same logsumexp/resample collectives as the plain filter).

No reference counterpart (the C++ library has no SSM tooling at all);
north-star scope. Hook contract (IMPORTANT — differs from
:func:`~mcmcpp_tpu.particle.particle_filter`): because θ varies per
particle, the ssm hooks receive ``theta`` as the full ``(N, P)`` batch
aligned with the particle axis of ``x`` — write ``theta[:, k]`` where a
fixed-θ model would write ``theta[k]``. Parameters with constrained
supports (variances, probabilities) should be carried unconstrained
(log/logit) so the Gaussian perturbation stays valid.
"""

from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from mcmcpp_tpu.particle import StateSpaceModel
from mcmcpp_tpu.smc import ess_from_log_weights, systematic_resample


class IF2Result(NamedTuple):
    theta: jnp.ndarray         # (P,) final estimate (mean of final swarm)
    swarm: jnp.ndarray         # (N, P) final θ-swarm
    theta_trace: jnp.ndarray   # (M, P) per-iteration swarm means
    theta_sd_trace: jnp.ndarray  # (M, P) per-iteration swarm sds
    loglik_trace: jnp.ndarray  # (M,) PF loglik estimate per pass


def if2(key, ssm: StateSpaceModel, ys, n_particles, theta0, sigma0,
        n_iters=30, cooling=0.9, ess_frac=1.0, mesh=None):
    """Run IF2. Returns :class:`IF2Result`.

    Parameters
    ----------
    ssm : hooks with the PER-PARTICLE-θ contract (module docstring).
    ys : (T,) or (T, E) observations.
    theta0 : (P,) swarm center; the initial swarm is θ0 + σ0·ξ.
    sigma0 : scalar or (P,) initial random-walk perturbation scale.
    n_iters : cooling iterations M (data passes).
    cooling : geometric σ decay per pass, σ_m = σ0·cooling^m (Ionides
        et al. recommend total cooling ~0.01-0.1 of σ0 by the last pass;
        with the 0.9 default that is ~0.04 at M=30).
    ess_frac : resampling trigger as in the plain filter; IF2's default
        is 1.0 (resample EVERY step, the paper's Bayes-map form).
    """
    from mcmcpp_tpu.parallel.mesh import particle_constrainer

    ys = jnp.asarray(ys)
    if ys.ndim == 1:
        ys = ys[:, None]
    n = int(n_particles)
    theta0 = jnp.asarray(theta0)
    p = theta0.shape[0]
    sigma0 = jnp.broadcast_to(jnp.asarray(sigma0, theta0.dtype), (p,))
    logn = jnp.log(jnp.asarray(float(n)))
    constrain = particle_constrainer(mesh, n)
    t_idx = jnp.arange(1, ys.shape[0])

    def one_pass(key, swarm, sigma):
        """One full data pass at perturbation scale sigma (P,)."""
        k_init, k_perturb0, k_scan = jax.random.split(key, 3)
        th = swarm + sigma[None, :] * jax.random.normal(
            k_perturb0, swarm.shape, swarm.dtype
        )
        x = ssm.init_sample(k_init, n, th)
        (th,) = constrain(th)
        ll0 = ssm.obs_logpdf(ys[0], x, 0, th)
        incr0 = jax.scipy.special.logsumexp(ll0) - logn
        lw = ll0 - jax.scipy.special.logsumexp(ll0)
        x, lw = constrain(x, lw)

        def step(carry, inp):
            x, th, lw, key = carry
            y, t = inp
            key, k_rs, k_th, k_x = jax.random.split(key, 4)
            do_rs = ess_from_log_weights(lw) < ess_frac * n
            idx = systematic_resample(k_rs, lw, n)
            idx = jnp.where(do_rs, idx, jnp.arange(n, dtype=jnp.int32))
            x = jnp.take(x, idx, axis=0)
            th = jnp.take(th, idx, axis=0)
            lw = jnp.where(do_rs, jnp.full((n,), -logn, lw.dtype), lw)
            th = th + sigma[None, :] * jax.random.normal(
                k_th, th.shape, th.dtype
            )
            x = ssm.trans_sample(k_x, x, t, th)
            ll = ssm.obs_logpdf(y, x, t, th)
            incr = jax.scipy.special.logsumexp(lw + ll)
            lw = lw + ll - incr
            x, lw = constrain(x, lw)
            (th,) = constrain(th)
            return (x, th, lw, key), incr

        (x, th, lw, _), incrs = jax.lax.scan(
            step, (x, th, lw, k_scan), (ys[1:], t_idx)
        )
        # final joint resample -> equal-weight swarm for the next pass
        k_last = jax.random.fold_in(key, 0x1F2)
        idx = systematic_resample(k_last, lw, n)
        th = jnp.take(th, idx, axis=0)
        (th,) = constrain(th)
        return th, incr0 + jnp.sum(incrs)

    one_pass = jax.jit(one_pass)

    k_swarm, key = jax.random.split(jnp.asarray(key))
    swarm = theta0[None, :] + sigma0[None, :] * jax.random.normal(
        k_swarm, (n, p), theta0.dtype
    )
    (swarm,) = constrain(swarm)
    means, sds, logliks = [], [], []
    for m in range(int(n_iters)):
        key, k_pass = jax.random.split(key)
        sigma = sigma0 * (float(cooling) ** (m + 1))
        swarm, loglik = one_pass(k_pass, swarm, sigma)
        means.append(jnp.mean(swarm, axis=0))
        sds.append(jnp.std(swarm, axis=0))
        logliks.append(loglik)
    theta_trace = jnp.stack(means)
    return IF2Result(
        theta=theta_trace[-1],
        swarm=swarm,
        theta_trace=theta_trace,
        theta_sd_trace=jnp.stack(sds),
        loglik_trace=jnp.stack(logliks),
    )
