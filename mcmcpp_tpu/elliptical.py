"""Elliptical slice sampling for Gaussian-prior latents.

Murray, Adams & MacKay (2010, AISTATS): for targets of the form
``posterior(f) ∝ N(f; mu, Sigma) · L(f)`` (GP latents, Gaussian random
fields, hierarchical Gaussian layers), propose on the ellipse through the
current state and a fresh prior draw, and shrink the angle bracket until
the likelihood threshold is met. Rejection-free, tuning-free, and exact —
the classic gradient-free kernel the ensemble movers can't replace when
the prior covariance is strong.

Accelerator shape: chains are a vmapped (C, P) batch (axis mesh-shardable); the
angle-shrinking loop is a batched masked ``while_loop`` (all chains
iterate until the LAST one accepts — same pattern as the zeus-style
ensemble slice move in movers/slice.py), and the prior rotation is one
(C, P) x (P, P) matmul.

No reference counterpart (the C++ library has no prior-structure-aware
kernels); north-star scope. Driver surface (init/run/get_samples)
matches the other samplers; storage via the shared Chain
(``MCMCpp/Chain/Chain.h`` analogue).
"""

from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from mcmcpp_tpu.chain import Chain, append_device_chunk


class EllipticalState(NamedTuple):
    position: jax.Array  # (C, P)
    loglike: jax.Array  # (C,)


class EllipticalSliceSampler:
    """``log_like_fn``: (P,) -> scalar log-likelihood (JAX-traceable).
    The Gaussian prior is given by ``prior_mean`` (P,) and either
    ``prior_chol`` (P, P) lower Cholesky or ``prior_scale`` (P,) for a
    diagonal prior. ``max_shrink`` bounds the bracket-shrinking loop
    (acceptance is guaranteed in exact arithmetic; the cap only guards
    non-finite likelihoods — on cap the chain keeps its state, which
    leaves the target invariant)."""

    def __init__(self, log_like_fn, prior_mean, prior_chol=None,
                 prior_scale=None, n_chains=32, seed=0, dtype=jnp.float32,
                 max_shrink=64, max_chain_bytes=2 << 30, mesh=None,
                 chain=None):
        self.dtype = dtype
        self.prior_mean = jnp.asarray(prior_mean, dtype)
        self.n_params = int(self.prior_mean.shape[0])
        if (prior_chol is None) == (prior_scale is None):
            raise ValueError(
                "pass exactly one of prior_chol= (P, P) or prior_scale= (P,)"
            )
        if prior_chol is not None:
            self.prior_chol = jnp.asarray(prior_chol, dtype)
            if self.prior_chol.shape != (self.n_params, self.n_params):
                raise ValueError("prior_chol must be (P, P)")
        else:
            scale = jnp.asarray(prior_scale, dtype)
            if scale.shape != (self.n_params,):
                raise ValueError("prior_scale must be (P,)")
            self.prior_chol = jnp.diag(scale)
        self.n_chains = int(n_chains)
        self.max_shrink = int(max_shrink)
        self._batched_loglike = jax.vmap(log_like_fn)
        self._key = jax.random.key(seed)
        self.state = None
        if chain is not None:
            if (chain.n_walkers, chain.n_params) != (
                self.n_chains, self.n_params,
            ):
                raise ValueError("injected chain store geometry mismatch")
            self.chain = chain
        else:
            self.chain = Chain(
                n_walkers=self.n_chains, n_params=self.n_params,
                max_bytes=max_chain_bytes,
                dtype=np.dtype(jax.dtypes.canonicalize_dtype(dtype)),
            )
        self.mesh = mesh
        self._chain_sharding = None
        if mesh is not None:
            from mcmcpp_tpu.parallel.mesh import walker_sharding

            if self.n_chains % mesh.size != 0:
                raise ValueError(
                    f"n_chains={self.n_chains} not divisible by mesh size "
                    f"{mesh.size}"
                )
            self._chain_sharding = walker_sharding(mesh)
        self._run_cache = {}

    def _constrain(self, state):
        if self._chain_sharding is None:
            return state
        from mcmcpp_tpu.parallel.mesh import vector_sharding

        c = lambda x: jax.lax.with_sharding_constraint(x, self._chain_sharding)
        v = lambda x: jax.lax.with_sharding_constraint(
            x, vector_sharding(self._chain_sharding)
        )
        return EllipticalState(c(state.position), v(state.loglike))

    def init(self, positions):
        positions = jnp.asarray(positions, self.dtype)
        if positions.shape != (self.n_chains, self.n_params):
            raise ValueError(
                f"positions must be ({self.n_chains}, {self.n_params})"
            )
        if self._chain_sharding is not None:
            positions = jax.device_put(positions, self._chain_sharding)
        self.state = EllipticalState(
            positions, self._batched_loglike(positions)
        )
        return self

    def init_prior(self, seed=None):
        """Start every chain at an independent prior draw."""
        key = self._key if seed is None else jax.random.key(seed)
        key = jax.random.fold_in(key, 0xE55)
        z = jax.random.normal(key, (self.n_chains, self.n_params), self.dtype)
        return self.init(self.prior_mean[None, :] + z @ self.prior_chol.T)

    # -- one transition for the whole (C, P) batch ---------------------------

    def _step(self, key, state):
        state = self._constrain(state)
        k_nu, k_u, k_theta, k_shrink = jax.random.split(key, 4)
        c = self.n_chains
        mu = self.prior_mean[None, :]
        z = jax.random.normal(k_nu, state.position.shape, self.dtype)
        nu = z @ self.prior_chol.T  # prior deviate around 0
        log_y = state.loglike + jnp.log(
            jax.random.uniform(k_u, (c,), self.dtype, minval=1e-37)
        )
        theta = jax.random.uniform(
            k_theta, (c,), self.dtype, 0.0, 2.0 * jnp.pi
        )
        lo, hi = theta - 2.0 * jnp.pi, theta
        centered = state.position - mu

        def propose(th):
            return (centered * jnp.cos(th)[:, None]
                    + nu * jnp.sin(th)[:, None] + mu)

        def cond(carry):
            i, _, _, _, _, done, _ = carry
            return (i < self.max_shrink) & ~jnp.all(done)

        def body(carry):
            i, th, lo, hi, key, done, out = carry
            pos = propose(th)
            ll = self._batched_loglike(pos)
            ok = ll > log_y
            newly = ok & ~done
            out = (
                jnp.where(newly[:, None], pos, out[0]),
                jnp.where(newly, ll, out[1]),
            )
            done = done | ok
            # Murray et al. shrinkage: pull the violated side to theta
            lo = jnp.where(~done & (th < 0), th, lo)
            hi = jnp.where(~done & (th >= 0), th, hi)
            key, sub = jax.random.split(key)
            u = jax.random.uniform(sub, (c,), self.dtype)
            th = jnp.where(done, th, lo + u * (hi - lo))
            return (i + 1, th, lo, hi, key, done, out)

        init = (
            jnp.int32(0), theta, lo, hi, k_shrink,
            jnp.zeros((c,), bool),
            (state.position, state.loglike),  # cap fallback: keep state
        )
        *_, out = jax.lax.while_loop(cond, body, init)
        return self._constrain(EllipticalState(out[0], out[1]))

    # -- driver --------------------------------------------------------------

    def _run_scan(self, state, key, n_store, thin):
        def body(carry, _):
            state, key = carry

            def inner(j, sk):
                s, k = sk
                k, sub = jax.random.split(k)
                return (self._step(sub, s), k)

            state, key = jax.lax.fori_loop(0, thin, inner, (state, key))
            return (state, key), (state.position, state.loglike)

        (state, _), (pos, ll) = jax.lax.scan(
            body, (state, key), length=n_store
        )
        return state, pos, ll

    def run(self, n_steps, thin=1):
        """Store every thin-th state; the stored "logp" column is the
        LOG-LIKELIHOOD (the prior factor is implicit in the kernel).
        ``n_steps % thin`` leftover transitions still advance the state
        (unstored), matching every other chunked driver.
        Returns False on chain byte-cap (EndOfChain)."""
        if self.state is None:
            raise RuntimeError("call init/init_prior first")
        thin = int(thin)
        n_store = int(n_steps) // thin
        leftover = int(n_steps) - n_store * thin
        from mcmcpp_tpu.chain import default_chunk_steps, run_pipelined

        chunk = default_chunk_steps(self.n_chains, self.n_params, self.dtype)

        def launch(take):
            fn = self._run_cache.get((take, thin))
            if fn is None:
                fn = jax.jit(
                    lambda st, k, t=take, th=thin: self._run_scan(
                        st, k, t, th
                    )
                )
                self._run_cache[(take, thin)] = fn
            self._key, run_key = jax.random.split(self._key)
            self.state, pos, ll = fn(self.state, run_key)
            return (pos, ll)

        def fetch(futures):
            self.chain, appended = append_device_chunk(
                self.chain, futures[0], futures[1]
            )
            return appended

        ok = run_pipelined(n_store, chunk, launch, fetch)
        if ok and leftover:
            fn = self._run_cache.get((1, leftover))
            if fn is None:
                fn = jax.jit(
                    lambda st, k, lo=leftover: self._run_scan(st, k, 1, lo)
                )
                self._run_cache[(1, leftover)] = fn
            self._key, run_key = jax.random.split(self._key)
            self.state, _, _ = fn(self.state, run_key)
        return ok

    def get_samples(self, burn_in=0, thin=1, flat=False):
        return self.chain.get(burn_in=burn_in, thin=thin, flat=flat)

    def get_log_likes(self, burn_in=0, thin=1, flat=False):
        return self.chain.get_logp(burn_in=burn_in, thin=thin, flat=flat)
