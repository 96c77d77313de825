"""Preconditioned Crank–Nicolson (pCN) for Gaussian-prior targets.

Cotter, Roberts, Stuart & White (2013, Statist. Sci.): for posteriors of
the form ``π(f) ∝ N(f; mu, Sigma) · L(f)`` the pCN proposal

    f' = mu + sqrt(1 − β²)·(f − mu) + β·ν,   ν ~ N(0, Sigma)

is REVERSIBLE with respect to the prior, so the Metropolis ratio reduces
to the likelihood alone: ``accept iff log u < log L(f') − log L(f)``.
That makes the kernel dimension-robust — it is well defined on function
space, so the acceptance rate does not degenerate as the discretization
P → ∞ (unlike random-walk MH, whose step size must shrink like P^{-1/2}).
The dimension-robust sibling of
:class:`~mcmcpp_tpu.elliptical.EllipticalSliceSampler` (same prior
machinery; pCN trades ESS's rejection-free shrinking loop for a single
fixed-cost likelihood evaluation per step and a tunable step β).

Accelerator shape: chains are a vmapped (C, P) batch (axis mesh-shardable); one
(C, P) × (P, P) prior-Cholesky matmul plus one batched
likelihood per step, branchless accept — the whole transition is a
single fused program with no data-dependent control flow.

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


class PCNState(NamedTuple):
    position: jax.Array  # (C, P)
    loglike: jax.Array   # (C,)
    accepted: jax.Array  # (C,) int32 per-chain accept counters


class PCNSampler:
    """``log_like_fn``: (P,) -> scalar log-likelihood (JAX-traceable).
    The Gaussian prior is given by ``prior_mean`` (P,) and either
    ``prior_chol`` (P, P) lower Cholesky or ``prior_scale`` (P,) for a
    diagonal prior. ``beta`` in (0, 1] is the pCN step size (β = 1 is an
    independence sampler from the prior; small β means local moves —
    tune for ~20–40% acceptance, which stays FLAT in P)."""

    def __init__(self, log_like_fn, prior_mean, prior_chol=None,
                 prior_scale=None, beta=0.2, n_chains=32, seed=0,
                 dtype=jnp.float32, max_chain_bytes=2 << 30, mesh=None,
                 chain=None):
        if not 0.0 < float(beta) <= 1.0:
            raise ValueError("beta must be in (0, 1]")
        self.beta = float(beta)
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
        self._batched_loglike = jax.vmap(log_like_fn)
        self._key = jax.random.key(seed)
        self.state = None
        self.total_steps = 0
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
        return PCNState(
            c(state.position), v(state.loglike), v(state.accepted)
        )

    def init(self, positions):
        positions = jnp.asarray(positions, self.dtype)
        if positions.shape != (self.n_chains, self.n_params):
            raise ValueError(
                f"positions must be ({self.n_chains}, {self.n_params})"
            )
        if self._chain_sharding is not None:
            positions = jax.device_put(positions, self._chain_sharding)
        self.state = PCNState(
            positions, self._batched_loglike(positions),
            jnp.zeros((self.n_chains,), jnp.int32),
        )
        self.total_steps = 0
        return self

    def init_prior(self, seed=None):
        """Start every chain at an independent prior draw."""
        key = self._key if seed is None else jax.random.key(seed)
        key = jax.random.fold_in(key, 0x9C4)
        z = jax.random.normal(key, (self.n_chains, self.n_params), self.dtype)
        return self.init(self.prior_mean[None, :] + z @ self.prior_chol.T)

    @property
    def acceptance_fraction(self):
        """Mean accept rate since init (dimension-robust: flat in P)."""
        if self.state is None or self.total_steps == 0:
            return 0.0
        return float(
            np.sum(np.asarray(self.state.accepted))
            / (self.total_steps * self.n_chains)
        )

    def tune(self, n_steps=400, target=0.3, window=20, rate=2.0,
             beta_min=1e-4):
        """Robbins–Monro adaptation of β toward ``target`` acceptance,
        then FREEZE (adapt-then-freeze keeps the subsequent sampled
        chain exactly π-invariant — the same pattern as
        ``PMMHSampler.tune``). ~20–40% acceptance is the useful band;
        because pCN acceptance is dimension-robust, one tune run
        transfers across discretization levels of the same problem.

        Runs ``n_steps`` unstored transitions in ``window``-step
        launches, updating ``log β`` by ``rate/k^0.6 · (acc − target)``
        per window (log space, clamped to (beta_min, 1]: the natural
        scale — β=1 is the finite upper boundary, unlike a logit
        parametrization which diverges there). Tuning steps do not
        count toward ``acceptance_fraction`` (counters reset at the
        end). Returns self; read the result off ``self.beta``.
        """
        if self.state is None:
            raise RuntimeError("call init/init_prior first")
        if not 0.0 < float(target) < 1.0:
            raise ValueError("target must be in (0, 1)")
        window = int(window)
        prev = int(np.sum(np.asarray(self.state.accepted)))
        for k in range(max(1, int(n_steps) // window)):
            # fresh program per beta value: beta is a TRACE-TIME
            # constant of the step (the cache key must include it)
            fn = self._run_cache.get(("tune", window, self.beta))
            if fn is None:
                fn = jax.jit(
                    lambda st, key, w=window: self._run_scan(st, key, 1, w)
                )
                self._run_cache[("tune", window, self.beta)] = fn
            self._key, run_key = jax.random.split(self._key)
            self.state, _, _ = fn(self.state, run_key)
            total = int(np.sum(np.asarray(self.state.accepted)))
            acc = (total - prev) / (window * self.n_chains)
            prev = total
            step = rate / (k + 1.0) ** 0.6
            log_beta = np.log(self.beta) + step * (acc - float(target))
            self.beta = float(np.clip(np.exp(log_beta), beta_min, 1.0))
        # freeze: zero the counters so acceptance_fraction reflects the
        # FIXED-kernel phase only
        self.state = self.state._replace(
            accepted=jnp.zeros((self.n_chains,), jnp.int32)
        )
        self.total_steps = 0
        return self

    # -- one transition for the whole (C, P) batch ---------------------------

    def _step(self, key, state):
        state = self._constrain(state)
        k_nu, k_acc = jax.random.split(key)
        mu = self.prior_mean[None, :]
        z = jax.random.normal(k_nu, state.position.shape, self.dtype)
        nu = z @ self.prior_chol.T
        rho = float(np.sqrt(1.0 - self.beta * self.beta))
        prop = mu + rho * (state.position - mu) + self.beta * nu
        ll = self._batched_loglike(prop)
        # prior-reversible proposal => likelihood-only Metropolis ratio
        log_u = -jax.random.exponential(
            k_acc, (self.n_chains,), self.dtype
        )
        accept = log_u < (ll - state.loglike)
        return self._constrain(PCNState(
            jnp.where(accept[:, None], prop, state.position),
            jnp.where(accept, ll, state.loglike),
            state.accepted + accept.astype(jnp.int32),
        ))

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
            # beta is a trace-time constant of the step: it must be part
            # of the program-cache key or a post-tune() run would reuse
            # a stale-beta executable
            fn = self._run_cache.get((take, thin, self.beta))
            if fn is None:
                fn = jax.jit(
                    lambda st, k, t=take, th=thin: self._run_scan(
                        st, k, t, th
                    )
                )
                self._run_cache[(take, thin, self.beta)] = fn
            self._key, run_key = jax.random.split(self._key)
            self.state, pos, ll = fn(self.state, run_key)
            self.total_steps += take * thin
            return (pos, ll)

        def fetch(futures):
            self.chain, appended = append_device_chunk(
                self.chain, futures[0], futures[1]
            )
            return appended

        ok = run_pipelined(n_store, chunk, launch, fetch)
        if ok and leftover:
            fn = self._run_cache.get((1, leftover, self.beta))
            if fn is None:
                fn = jax.jit(
                    lambda st, k, lo=leftover: self._run_scan(st, k, 1, lo)
                )
                self._run_cache[(1, leftover, self.beta)] = fn
            self._key, run_key = jax.random.split(self._key)
            self.state, _, _ = fn(self.state, run_key)
            self.total_steps += leftover
        return ok

    def get_samples(self, burn_in=0, thin=1, flat=False):
        return self.chain.get(burn_in=burn_in, thin=thin, flat=flat)

    def get_log_likes(self, burn_in=0, thin=1, flat=False):
        return self.chain.get_logp(burn_in=burn_in, thin=thin, flat=flat)
