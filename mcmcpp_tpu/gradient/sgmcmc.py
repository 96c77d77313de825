"""Stochastic-gradient MCMC: SGLD and SGHMC over minibatched data.

Production-scale Bayesian inference where one full-data gradient per step
is unaffordable: the likelihood gradient is estimated from a random
minibatch and scaled by ``N/B`` (unbiased). Welling & Teh (2011) SGLD and
Chen, Fox & Guestrin (2014) SGHMC (momentum + friction absorbing the
gradient-noise injection). There is no Metropolis correction — the bias
is O(step_size); use a small constant step or the polynomial decay
schedule ``step_size_decay``.

Accelerator shape: ONE shared minibatch per step (a single gather from the
device-resident data pytree, amortized across all chains), chains vmapped
as a (C, P) batch whose axis shards over the mesh like every other
sampler; the data pytree stays replicated per device. The stored "logp"
is the minibatch ESTIMATE ``logprior + (N/B)·loglike(batch)`` — unbiased
for the full-data log-likelihood part but noisy; don't use it for model
comparison.

No reference counterpart (gradient-free black-box Calculator,
``/root/reference/MCMCpp/Utility/UserOjbectsTest.h:144-151``) —
north-star large-data scope.
"""

from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from mcmcpp_tpu.chain import Chain, append_device_chunk


class SGState(NamedTuple):
    position: jax.Array  # (C, P)
    velocity: jax.Array  # (C, P); zeros (unused) for SGLD
    step: jax.Array  # () int32, drives the decay schedule


class StochasticGradientSampler:
    """Shared driver for minibatch kernels (SGLD / SGHMC subclasses).

    ``logprior_fn(theta (P,)) -> scalar``; ``loglike_fn(theta, batch) ->
    scalar`` is the SUM of log-likelihood terms over the minibatch rows
    (``batch`` is ``data`` sliced to ``batch_size`` leading rows).
    ``data``: pytree of arrays sharing leading axis ``N``.

    ``step_size_decay=(t0, gamma)`` applies
    ``eps_t = step_size * (1 + t/t0)**(-gamma)`` (Welling & Teh's
    polynomial schedule); ``None`` keeps a constant step.
    """

    def __init__(self, logprior_fn, loglike_fn, data, n_chains, n_params,
                 batch_size, seed=0, dtype=jnp.float32, step_size=1e-3,
                 step_size_decay=None, max_chain_bytes=2 << 30, mesh=None,
                 chain=None):
        self.logprior_fn = logprior_fn
        self.loglike_fn = loglike_fn
        self.data = jax.tree.map(jnp.asarray, data)
        sizes = {int(x.shape[0]) for x in jax.tree.leaves(self.data)}
        if len(sizes) != 1:
            raise ValueError(f"data leaves disagree on leading axis: {sizes}")
        self.n_data = sizes.pop()
        self.batch_size = int(batch_size)
        if not 0 < self.batch_size <= self.n_data:
            raise ValueError(
                f"batch_size={batch_size} not in (0, {self.n_data}]"
            )
        self.n_chains = int(n_chains)
        self.n_params = int(n_params)
        self.dtype = dtype
        self.step_size = float(step_size)
        if step_size_decay is not None:
            t0, gamma = step_size_decay
            if not (t0 > 0 and 0 < gamma <= 1):
                raise ValueError("step_size_decay = (t0 > 0, 0 < gamma <= 1)")
        self.step_size_decay = step_size_decay
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
        self._step = self._make_step()

    # -- stochastic gradient estimate ---------------------------------------

    def _grad_est(self):
        scale = self.n_data / self.batch_size

        def logp_est(theta, batch):
            return self.logprior_fn(theta) + scale * self.loglike_fn(
                theta, batch
            )

        return jax.vmap(jax.value_and_grad(logp_est), in_axes=(0, None))

    def _eps_at(self, t):
        eps = jnp.asarray(self.step_size, self.dtype)
        if self.step_size_decay is None:
            return eps
        t0, gamma = self.step_size_decay
        return eps * (1.0 + t.astype(self.dtype) / t0) ** (-gamma)

    def _make_step(self):
        """Subclass hook: (key, state) -> (state, (pos_eval, lp_est))
        where ``lp_est`` is the minibatch estimate AT ``pos_eval`` (the
        pre-transition position), so stored (position, logp) pairs are
        always evaluated at the same point."""
        raise NotImplementedError

    def _constrain(self, state):
        if self._chain_sharding is None:
            return state
        c = lambda x: jax.lax.with_sharding_constraint(x, self._chain_sharding)
        return SGState(c(state.position), c(state.velocity), state.step)

    def _sample_batch(self, key):
        idx = jax.random.randint(
            key, (self.batch_size,), 0, self.n_data
        )
        return jax.tree.map(lambda x: x[idx], self.data)

    # -- init / run ----------------------------------------------------------

    def init(self, positions):
        positions = jnp.asarray(positions, self.dtype)
        if positions.shape != (self.n_chains, self.n_params):
            raise ValueError(
                f"positions must be ({self.n_chains}, {self.n_params})"
            )
        if self._chain_sharding is not None:
            positions = jax.device_put(positions, self._chain_sharding)
        self.state = SGState(
            positions, jnp.zeros_like(positions), jnp.zeros((), jnp.int32)
        )
        return self

    def init_ball(self, center, scale=1.0, seed=None):
        key = self._key if seed is None else jax.random.key(seed)
        key = jax.random.fold_in(key, 0x56D)
        center = jnp.asarray(center, self.dtype)
        z = jax.random.normal(key, (self.n_chains, self.n_params), self.dtype)
        return self.init(center[None, :] + scale * z)

    def _run_scan(self, state, key, n_store, thin):
        step = self._step

        def body(carry, _):
            state, key, out = carry

            def inner(j, sk):
                s, k, _ = sk
                k, sub = jax.random.split(k)
                s, out = step(sub, s)
                return (s, k, out)

            state, key, (pos, lp) = jax.lax.fori_loop(
                0, thin, inner, (state, key, out)
            )
            return (state, key, (pos, lp)), (pos, lp)

        out0 = (state.position, jnp.zeros((self.n_chains,), self.dtype))
        (state, _, _), (pos, lps) = jax.lax.scan(
            body, (state, key, out0), length=n_store
        )
        return state, pos, lps

    def run(self, n_steps, thin=1):
        """Advance ``n_steps``, storing every thin-th (position, logp
        estimate) pair — both evaluated at the same point, the position
        the final kernel of each thin window evaluated (one transition
        behind the live state). ``n_steps % thin`` leftover transitions
        still advance the state, unstored. Pipelines device->host like
        the other drivers; returns False on chain byte-cap (EndOfChain).
        """
        if self.state is None:
            raise RuntimeError("call init/init_ball first")
        thin = int(thin)
        n_store = int(n_steps) // thin
        leftover = int(n_steps) - n_store * thin
        from mcmcpp_tpu.chain import default_chunk_steps, run_pipelined

        chunk = default_chunk_steps(self.n_chains, self.n_params, self.dtype)

        def launch(take):
            fn = self._run_cache.get((take, thin))
            if fn is None:
                fn = jax.jit(
                    lambda st, k, t=take, th=thin: self._run_scan(st, k, t, th)
                )
                self._run_cache[(take, thin)] = fn
            self._key, run_key = jax.random.split(self._key)
            self.state, pos, lps = fn(self.state, run_key)
            return (pos, lps)

        def fetch(futures):
            self.chain, appended = append_device_chunk(
                self.chain, futures[0], futures[1]
            )
            return appended

        ok = run_pipelined(n_store, chunk, launch, fetch)
        if ok and leftover:
            launch_fn = self._run_cache.get((1, leftover))
            if launch_fn is None:
                launch_fn = jax.jit(
                    lambda st, k, lo=leftover: self._run_scan(st, k, 1, lo)
                )
                self._run_cache[(1, leftover)] = launch_fn
            self._key, run_key = jax.random.split(self._key)
            self.state, _, _ = launch_fn(self.state, run_key)
        return ok

    def get_samples(self, burn_in=0, thin=1, flat=False):
        return self.chain.get(burn_in=burn_in, thin=thin, flat=flat)

    def get_log_probs(self, burn_in=0, thin=1, flat=False):
        """Minibatch logp ESTIMATES (see module docstring)."""
        return self.chain.get_logp(burn_in=burn_in, thin=thin, flat=flat)


class SGLDSampler(StochasticGradientSampler):
    """Stochastic Gradient Langevin Dynamics (Welling & Teh 2011):
    ``theta += (eps/2)·ghat + N(0, eps)`` — SGD that anneals into an
    (uncorrected) Langevin sampler."""

    def _make_step(self):
        grad_est = self._grad_est()

        def step(key, state):
            state = self._constrain(state)
            k_batch, k_noise = jax.random.split(key)
            batch = self._sample_batch(k_batch)
            lp, g = grad_est(state.position, batch)
            eps = self._eps_at(state.step)
            z = jax.random.normal(
                k_noise, state.position.shape, self.dtype
            )
            pos = state.position + 0.5 * eps * g + jnp.sqrt(eps) * z
            return (
                self._constrain(SGState(pos, state.velocity, state.step + 1)),
                (state.position, lp),
            )

        return step


class SGHMCSampler(StochasticGradientSampler):
    """Stochastic Gradient HMC (Chen, Fox & Guestrin 2014): momentum with
    friction ``alpha`` absorbing the minibatch gradient noise:
    ``v = (1-alpha)·v + eps·ghat + N(0, 2·alpha·eps); theta += v``."""

    def __init__(self, *args, friction=0.1, **kwargs):
        self.friction = float(friction)
        if not 0 < self.friction <= 1:
            raise ValueError("friction must be in (0, 1]")
        super().__init__(*args, **kwargs)

    def _make_step(self):
        grad_est = self._grad_est()
        alpha = self.friction

        def step(key, state):
            state = self._constrain(state)
            k_batch, k_noise = jax.random.split(key)
            batch = self._sample_batch(k_batch)
            lp, g = grad_est(state.position, batch)
            eps = self._eps_at(state.step)
            z = jax.random.normal(
                k_noise, state.position.shape, self.dtype
            )
            v = (
                (1.0 - alpha) * state.velocity
                + eps * g
                + jnp.sqrt(2.0 * alpha * eps) * z
            )
            return (
                self._constrain(
                    SGState(state.position + v, v, state.step + 1)
                ),
                (state.position, lp),
            )

        return step
