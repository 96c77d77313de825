"""Stein variational gradient descent (SVGD).

Liu & Wang (2016). A deterministic ensemble-inference method between
VI and MCMC: N particles descend the KL to the target along the Stein
variational direction

    φ(x_i) = (1/N) Σ_j [ k(x_j, x_i) ∇log p(x_j) + ∇_{x_j} k(x_j, x_i) ],

whose two terms are a kernel-weighted consensus on the score (drift
toward probability mass) and a repulsive kernel gradient (spread that
prevents mode collapse). At N=1 it reduces to gradient ascent on log p;
as N grows the particle measure approximates the posterior — with far
fewer evaluations than MCMC on smooth moderate-dimension targets, and
unlike parametric VI (:class:`~mcmcpp_tpu.vi.ADVI`) it is not confined
to a Gaussian family.

No reference counterpart (the C++ reference is ensemble MCMC only);
north-star scope completing the VI layer: parametric (ADVI), flow
(NeuTra), quasi-Newton path (Pathfinder), and now nonparametric-particle
(SVGD). Pairs naturally with :mod:`mcmcpp_tpu.analysis.ksd`: KSD is the
quality measure for exactly this kind of particle approximation (same
Stein operator, same score-only access).

Accelerator-native design
-----------------
One update is three (N, N)/(N, P) matmuls plus elementwise maps — the
same pairwise-algebra diet as the KSD module, all matmul work: squared
distances from one Gram product, the kernel-score consensus as
``K @ scores``, and the repulsion term in closed form for the RBF
kernel (``(Σ_j K_ij) x_i − K @ x``, ×2/h). The whole fit is a single
``lax.scan`` over steps (one compiled program; no per-step dispatch),
with the median-heuristic bandwidth recomputed inside the loop — a
top-k-free median via sorting the (N²,) distance vector, cheap at the
N ≲ few-thousand scale SVGD operates at.
"""

from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

__all__ = ["SVGD", "SVGDResult"]


class SVGDResult(NamedTuple):
    particles: jnp.ndarray      # (N, P) final particle cloud
    grad_norm_history: jnp.ndarray  # (steps,) mean |phi| per step


class SVGD:
    """Stein variational gradient descent over a JAX-traceable log
    density.

    logp_fn : (P,) -> scalar (unnormalized fine; only the score enters).
    n_particles / n_params : cloud shape.
    bandwidth : RBF LENGTHSCALE ℓ (the kernel is exp(−‖x−y‖²/ℓ²)), or
        ``"median"`` (default) for the median heuristic — the SQUARED
        scale h = med²/log N recomputed every step (Liu & Wang 2016
        §5; i.e. ℓ_median = √h) — scale-free and the standard choice.
    step_size : AdaGrad step size (the reference implementation's
        optimizer; monotone per-coordinate scaling keeps the repulsion
        from being drowned early).
    mesh : optional — shards the particle axis; the (N, N) products
        become collective matmuls (CPU-mesh parity tested).
    """

    def __init__(self, logp_fn, n_particles, n_params, step_size=0.1,
                 bandwidth="median", seed=0, dtype=jnp.float32,
                 mesh=None):
        self.logp_fn = logp_fn
        self.n = int(n_particles)
        self.n_params = int(n_params)
        self.step_size = float(step_size)
        if bandwidth != "median":
            bandwidth = float(bandwidth)
            if bandwidth <= 0:
                raise ValueError("bandwidth must be positive or 'median'")
        self.bandwidth = bandwidth
        self.dtype = dtype
        self._key = jax.random.key(seed)
        self._score = jax.vmap(jax.grad(logp_fn))
        self.particles = None
        from mcmcpp_tpu.parallel.mesh import particle_constrainer

        self._constrainer = particle_constrainer(mesh, self.n)
        self._fit_cache = {}   # (n_steps, adagrad_eps) -> jitted scan

    def _constrain(self, x):
        return self._constrainer(x)[0]

    def init(self, positions=None, scale=1.0, seed=None):
        """Start from ``positions`` (N, P) or a N(0, scale²) ball."""
        if positions is None:
            key = self._key if seed is None else jax.random.key(seed)
            self._key, k = jax.random.split(key)
            positions = scale * jax.random.normal(
                k, (self.n, self.n_params), self.dtype
            )
        positions = jnp.asarray(positions, self.dtype)
        if positions.shape != (self.n, self.n_params):
            raise ValueError(
                f"positions must be ({self.n}, {self.n_params})"
            )
        self.particles = self._constrain(positions)
        return self

    def _phi(self, x):
        """The Stein variational direction for the whole cloud (N, P)."""
        n = self.n
        scores = self._score(x)                       # (N, P)
        sq = jnp.sum(x * x, axis=1)
        d2 = sq[:, None] + sq[None, :] - 2.0 * (x @ x.T)
        d2 = jnp.maximum(d2, 0.0)
        if self.bandwidth == "median":
            med = jnp.median(d2)
            h = jnp.maximum(med, 1e-12) / np.log(max(n, 2))
        else:
            h = jnp.asarray(self.bandwidth ** 2, x.dtype)
        k_mat = jnp.exp(-d2 / h)                      # (N, N)
        # consensus drift + closed-form RBF repulsion:
        #   Σ_j ∇_{x_j} k(x_j, x_i) = (2/h) (Σ_j k_ij x_i − (Kᵀx)_i)
        drift = k_mat.T @ scores
        repulse = (2.0 / h) * (
            jnp.sum(k_mat, axis=0)[:, None] * x - k_mat.T @ x
        )
        return (drift + repulse) / n

    def fit(self, n_steps=500, adagrad_eps=1e-6):
        """Run ``n_steps`` SVGD updates in ONE jitted scan. Returns
        :class:`SVGDResult`; the cloud also stays on ``self.particles``
        so ``fit`` can be called again to continue."""
        if self.particles is None:
            self.init()
        eps = float(adagrad_eps)

        def body(carry, _):
            x, acc = carry
            phi = self._phi(x)
            acc = acc + phi * phi
            x = x + self.step_size * phi / jnp.sqrt(acc + eps)
            x = self._constrain(x)
            return (x, acc), jnp.mean(jnp.linalg.norm(phi, axis=-1))

        # step_size/bandwidth are trace-time constants of the cached
        # program — key on them so reassignment never reuses stale code
        # (the inv_mass lesson, gradient/mclmc.py)
        cache_key = (int(n_steps), eps, self.step_size, self.bandwidth)
        fn = self._fit_cache.get(cache_key)
        if fn is None:
            fn = jax.jit(
                lambda x0, s=int(n_steps): jax.lax.scan(
                    body, (x0, jnp.zeros_like(x0)), length=s
                )
            )
            self._fit_cache[cache_key] = fn
        (x, _), hist = fn(self.particles)
        self.particles = x
        return SVGDResult(x, hist)

    def get_samples(self):
        """(N, P) current particle cloud (equal-weight draws)."""
        if self.particles is None:
            raise RuntimeError("call init()/fit() first")
        return np.asarray(self.particles)
