"""Blocked Gibbs: composable per-block kernels in one jitted sweep.

Metropolis-within-Gibbs over named parameter blocks, each updated by the
kernel that fits its conditional structure — the classic pattern for
latent-Gaussian models (GP regression with unknown hypers: elliptical
slice for the N-dim latent conditioned on the kernel matrix, a gradient
kernel for the hyperparameters conditioned on the latent). No reference
counterpart (jmatta1/MCMCpp has single-kernel samplers only); north-star
scope, alongside the other compound engines.

Accelerator shape: one Gibbs sweep is a pure function over a dict of (size,)
blocks; the chain axis is one ``vmap`` (so C chains run the sweep in
lockstep, matmuls batched), steps are a ``lax.scan``, and
storage reuses the shared pipelined host loop (``chain.run_pipelined``).
Kernels may compute per-block structure from the OTHER blocks' current
values (e.g. a Cholesky that depends on live hyperparameters).

Kernel contract (unbatched; the driver vmaps):

    kernel.step(key, x (size,), others: {name: (their_size,)}) -> new x

Each conditional-density callable receives ``(x, others)``.
"""

from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from mcmcpp_tpu.chain import Chain, append_device_chunk, \
    default_chunk_steps, run_pipelined


class EllipticalSliceKernel:
    """Exact rejection-free update for a block with a Gaussian prior
    (Murray, Adams & MacKay 2010; same algorithm as
    ``elliptical.EllipticalSliceSampler``, here as a conditional kernel).

    loglike_fn(x, others) -> scalar log-likelihood of this block.
    The prior is N(mean, L Lᵀ): ``prior_mean`` is a constant or a
    function of ``others``; give exactly one of ``prior_chol`` /
    ``prior_scale`` (each a constant or a function of ``others`` —
    a live hyperparameter-dependent covariance is the point).
    """

    def __init__(self, loglike_fn, prior_mean=0.0, prior_chol=None,
                 prior_scale=None, max_shrink=64):
        if (prior_chol is None) == (prior_scale is None):
            raise ValueError(
                "pass exactly one of prior_chol= or prior_scale="
            )
        self._loglike = loglike_fn
        self._mean = prior_mean
        self._chol = prior_chol
        self._scale = prior_scale
        self.max_shrink = int(max_shrink)

    def _resolve(self, spec, others):
        return spec(others) if callable(spec) else jnp.asarray(spec)

    def step(self, key, x, others):
        mu = jnp.broadcast_to(self._resolve(self._mean, others), x.shape)
        k_nu, k_u, k_theta, k_shrink = jax.random.split(key, 4)
        z = jax.random.normal(k_nu, x.shape, x.dtype)
        if self._chol is not None:
            nu = self._resolve(self._chol, others) @ z
        else:
            nu = self._resolve(self._scale, others) * z
        log_y = self._loglike(x, others) + jnp.log(
            jax.random.uniform(k_u, (), x.dtype, minval=1e-37)
        )
        theta = jax.random.uniform(k_theta, (), x.dtype, 0.0, 2.0 * jnp.pi)
        lo, hi = theta - 2.0 * jnp.pi, theta
        centered = x - mu

        def propose(th):
            return centered * jnp.cos(th) + nu * jnp.sin(th) + mu

        def cond(c):
            i, _, _, _, _, done, _ = c
            return (i < self.max_shrink) & ~done

        def body(c):
            i, th, lo, hi, key, done, out = c
            pos = propose(th)
            ok = self._loglike(pos, others) > log_y
            out = jnp.where(ok, pos, out)
            done = done | ok
            # Murray et al. shrinkage: pull the violated side to theta
            lo = jnp.where(~done & (th < 0), th, lo)
            hi = jnp.where(~done & (th >= 0), th, hi)
            key, sub = jax.random.split(key)
            u = jax.random.uniform(sub, (), x.dtype)
            th = jnp.where(done, th, lo + u * (hi - lo))
            return (i + 1, th, lo, hi, key, done, out)

        # cap fallback keeps the current state (leaves the target invariant)
        init = (jnp.int32(0), theta, lo, hi, k_shrink, jnp.asarray(False), x)
        *_, out = jax.lax.while_loop(cond, body, init)
        return out


class MALAKernel:
    """One Metropolis-adjusted Langevin step on this block's conditional
    log density ``logp_fn(x, others)`` (unnormalized is fine)."""

    def __init__(self, logp_fn, step_size):
        self._logp = logp_fn
        self.step_size = float(step_size)

    def step(self, key, x, others):
        eps = jnp.asarray(self.step_size, x.dtype)
        vg = jax.value_and_grad(lambda v: self._logp(v, others))
        kp, ka = jax.random.split(key)
        lp, g = vg(x)
        noise = jax.random.normal(kp, x.shape, x.dtype)
        prop = x + 0.5 * eps**2 * g + eps * noise
        lp2, g2 = vg(prop)
        fwd = -jnp.sum((prop - x - 0.5 * eps**2 * g) ** 2) / (2 * eps**2)
        rev = -jnp.sum((x - prop - 0.5 * eps**2 * g2) ** 2) / (2 * eps**2)
        log_ratio = lp2 - lp + rev - fwd
        log_u = -jax.random.exponential(ka, (), x.dtype)
        return jnp.where(log_u < log_ratio, prop, x)


class HMCKernel:
    """Leapfrog HMC on this block's conditional ``logp_fn(x, others)``
    (identity mass). The leapfrog count is drawn uniformly from
    {1, …, n_leapfrog} each step (Neal 2011 §3.2) — a fixed length
    resonates with the conditional's frequencies (ε·L ≈ π on a unit
    Gaussian flips sign deterministically and freezes the radius)."""

    def __init__(self, logp_fn, step_size, n_leapfrog=8):
        self._logp = logp_fn
        self.step_size = float(step_size)
        self.n_leapfrog = int(n_leapfrog)

    def step(self, key, x, others):
        eps = jnp.asarray(self.step_size, x.dtype)
        vg = jax.value_and_grad(lambda v: self._logp(v, others))
        kp, kl, ka = jax.random.split(key, 3)
        p0 = jax.random.normal(kp, x.shape, x.dtype)
        lp0, g = vg(x)
        n_leap = jax.random.randint(kl, (), 1, self.n_leapfrog + 1)

        def leap(i, c):
            q, p, g = c
            p = p + 0.5 * eps * g
            q = q + eps * p
            _, g = vg(q)
            p = p + 0.5 * eps * g
            return (q, p, g)

        q, p, _ = jax.lax.fori_loop(0, n_leap, leap, (x, p0, g))
        lp1, _ = vg(q)
        log_ratio = (lp1 - lp0) - 0.5 * (jnp.sum(p * p) - jnp.sum(p0 * p0))
        log_u = -jax.random.exponential(ka, (), x.dtype)
        return jnp.where(log_u < log_ratio, q, x)


class RWMKernel:
    """Gaussian random-walk Metropolis on ``logp_fn(x, others)``."""

    def __init__(self, logp_fn, scale):
        self._logp = logp_fn
        self.scale = scale

    def step(self, key, x, others):
        kp, ka = jax.random.split(key)
        prop = x + jnp.asarray(self.scale, x.dtype) * jax.random.normal(
            kp, x.shape, x.dtype
        )
        log_ratio = self._logp(prop, others) - self._logp(x, others)
        log_u = -jax.random.exponential(ka, (), x.dtype)
        return jnp.where(log_u < log_ratio, prop, x)


class CategoricalGibbsKernel:
    """Exact Gibbs update for a block of DISCRETE sites that are
    conditionally independent given the other blocks — the classic
    data-augmentation move for mixture-model component assignments
    (z_i | θ, y_i is categorical and independent across i).

    logits_fn(others) -> (S, V) unnormalized log-probabilities for each
    of the S sites over V categories. The whole block resamples in one
    vectorized categorical draw (no Metropolis step: the conditional is
    sampled exactly). Values are stored as floats in {0, …, V-1}.

    No other engine here handles un-marginalized discrete latents (the
    gradient family needs differentiability; the ensemble movers assume
    continuous supports) — pair this block with continuous kernels for
    the component parameters.
    """

    def __init__(self, logits_fn):
        self._logits = logits_fn

    def step(self, key, x, others):
        logits = self._logits(others)
        draws = jax.random.categorical(key, logits, axis=-1)  # (S,)
        return draws.astype(x.dtype)


class ExactGibbsKernel:
    """A block whose full conditional can be sampled EXACTLY (conjugate
    updates: Normal means, Gamma rates/precisions, Dirichlet weights…).

    sample_fn(key, others) -> new block value (size,). No accept step —
    this is textbook Gibbs, the highest-quality move available when
    conjugacy holds.
    """

    def __init__(self, sample_fn):
        self._sample = sample_fn

    def step(self, key, x, others):
        return jnp.asarray(self._sample(key, others), x.dtype)


class GaussianInterweaveKernel:
    """Joint (hyper, latent) update by ancillarity-sufficiency
    interweaving (ASIS, Yu & Meng 2011) for Gaussian-latent models
    ``f = chol(h) @ e``, ``e ~ N(0, I)``, data likelihood ``loglike(f)``.

    Plain Gibbs mixes glacially here whichever parametrization you pick:
    centered leaves h | f prior-tight when the data are informative;
    non-centered leaves h | e likelihood-tight. Interweaving does BOTH
    conditionals back-to-back through the exact coordinate switch, which
    breaks the ridge (the measured difference on the GP example is
    convergence in hundreds of sweeps vs none in thousands).

    Declare as a JOINT block over (hyper, latent)::

        BlockedGibbsSampler([
            (("h", "e"), (2, N), GaussianInterweaveKernel(
                loglike, chol_fn, hyper_logprior,
                lambda logp: HMCKernel(logp, 0.02, 8))),
        ], ...)

    loglike_fn(f) -> scalar data log-likelihood of the latent.
    chol_fn(h) -> (N, N) lower Cholesky of the latent prior covariance.
    hyper_logprior(h) -> scalar.
    make_hyper_kernel(logp_fn) -> a single-block kernel (HMC/MALA/RWM)
        used for both hyper sub-updates.

    One step = ESS on e | h, then h | e (ancillary / non-centered),
    switch to f, then h | f (sufficient / centered), switch back.
    """

    def __init__(self, loglike_fn, chol_fn, hyper_logprior,
                 make_hyper_kernel, max_shrink=64):
        self._like = loglike_fn
        self._chol = chol_fn
        self._prior = hyper_logprior
        self._mk = make_hyper_kernel
        self.max_shrink = int(max_shrink)

    def step(self, key, values, others):
        h, e = values
        k0, k1, k2 = jax.random.split(key, 3)
        # phase 0: ESS on the whitened latent given h
        chol_h = self._chol(h)
        ess = EllipticalSliceKernel(
            lambda e_, o: self._like(chol_h @ e_),
            prior_scale=jnp.ones(e.shape[-1], e.dtype),
            max_shrink=self.max_shrink,
        )
        e = ess.step(k0, e, {})
        # phase 1 (ancillary): h | e — likelihood-coupled conditional
        nc = self._mk(
            lambda h_, o: self._prior(h_) + self._like(self._chol(h_) @ e)
        )
        h = nc.step(k1, h, {})
        # phase 2 (sufficient): h | f — prior-coupled conditional
        f = self._chol(h) @ e

        def c_logp(h_, o):
            chol = self._chol(h_)
            w = jax.scipy.linalg.solve_triangular(chol, f, lower=True)
            return (self._prior(h_) - 0.5 * jnp.sum(w * w)
                    - jnp.sum(jnp.log(jnp.diagonal(chol))))

        h = self._mk(c_logp).step(k2, h, {})
        # exact coordinate switch back: f is held fixed through phase 2
        e = jax.scipy.linalg.solve_triangular(
            self._chol(h), f, lower=True
        )
        return (h, e)


class InterweaveKernel:
    """General ancillarity-sufficiency interweaving (ASIS, Yu & Meng
    2011) for an arbitrary smooth hyper-indexed coupling ``f = T_h(e)``.

    Generalizes :class:`GaussianInterweaveKernel` beyond the
    linear-Gaussian ``f = chol(h) @ e`` case: any transport between a
    centered latent ``f`` (whose prior depends on the hyper ``h``) and
    an ancillary latent ``e`` (whose density is ``h``-free) qualifies —
    log-normal random effects (``f = mu + exp(lam)·e``), heavy-tailed
    scale mixtures, monotone warps. The joint over ``(h, e)`` is
    ``p(h)·q(e)·L(T_h(e))``; the centered conditional uses the exact
    change of variables ``log p(f|h) = q(T_h⁻¹(f)) + log|det ∂e/∂f|``.

    forward(h, e) -> f            the transport T_h
    inverse(h, f) -> e            its inverse at fixed h
    anc_logpdf(e) -> scalar       h-free density of the ancillary latent
    loglike(f) -> scalar          data log-likelihood over the centered latent
    hyper_logprior(h) -> scalar
    make_hyper_kernel(logp_fn) -> single-block kernel (HMC/MALA/RWM),
        built twice per step for the two h conditionals.
    make_latent_kernel(logp_fn) -> kernel for the e | h update
        (default: ``RWMKernel(logp, latent_rwm_scale)``).
    log_det_inverse(h, f) -> scalar log|det ∂e/∂f| at fixed h. For
        elementwise transports this is a cheap analytic sum (e.g.
        ``-N·lam`` for ``e = (f - mu)·exp(-lam)``); if None it is
        computed by ``jax.jacfwd`` + ``slogdet`` — exact but O(N²)
        storage / O(N³) work, fine only for small latent blocks.

    One step = latent update in the ancillary coordinates, h | e
    (ancillary conditional), exact switch to f = T_h(e), h | f
    (sufficient conditional), exact switch back. f is held fixed
    through the sufficient phase, so the two h moves see genuinely
    different geometry — that is what breaks the centered /
    non-centered funnel ridge.
    """

    def __init__(self, forward, inverse, anc_logpdf, loglike,
                 hyper_logprior, make_hyper_kernel,
                 make_latent_kernel=None, log_det_inverse=None,
                 latent_rwm_scale=0.5):
        self._fwd = forward
        self._inv = inverse
        self._anc = anc_logpdf
        self._like = loglike
        self._prior = hyper_logprior
        self._mk_h = make_hyper_kernel
        self._mk_e = make_latent_kernel or (
            lambda logp: RWMKernel(logp, latent_rwm_scale)
        )
        if log_det_inverse is None:
            def log_det_inverse(h, f):
                jac = jax.jacfwd(lambda f_: self._inv(h, f_))(f)
                jac = jnp.atleast_2d(jac)
                return jnp.linalg.slogdet(jac)[1]
        self._ldet = log_det_inverse

    def step(self, key, values, others):
        h, e = values
        k0, k1, k2 = jax.random.split(key, 3)
        # phase 0: e | h in the ancillary coordinates
        e = self._mk_e(
            lambda e_, o: self._anc(e_) + self._like(self._fwd(h, e_))
        ).step(k0, e, {})
        # phase 1 (ancillary): h | e — likelihood-coupled conditional
        h = self._mk_h(
            lambda h_, o: self._prior(h_) + self._like(self._fwd(h_, e))
        ).step(k1, h, {})
        # phase 2 (sufficient): h | f — prior-coupled conditional
        f = self._fwd(h, e)
        h = self._mk_h(
            lambda h_, o: (self._prior(h_) + self._anc(self._inv(h_, f))
                           + self._ldet(h_, f))
        ).step(k2, h, {})
        # exact coordinate switch back: f held fixed through phase 2
        e = self._inv(h, f)
        return (h, e)


class BlockedGibbsSampler:
    """Sequential per-block kernel sweep, C chains in lockstep.

    blocks: list of ``(name, size, kernel)``; sweep order is list order.
        A JOINT entry ``((n1, n2), (s1, s2), kernel)`` updates several
        blocks in one kernel step (``kernel.step(key, (v1, v2), others)
        -> (v1', v2')``) — used by interweaving kernels.
    logp_fn (optional): joint log density over the values dict, stored as
        the chain's logp column (zeros if omitted).
    Storage is flat ``(C, Σ size)`` rows in block declaration order;
    ``get_block(name)`` slices a block back out.
    """

    def __init__(self, blocks, n_chains, logp_fn=None, seed=0,
                 dtype=jnp.float32, max_chain_bytes=2 << 30, mesh=None,
                 chain=None, max_chunk_steps=None):
        if not blocks:
            raise ValueError("need at least one block")
        self.blocks = []
        for n, s, k in blocks:
            if isinstance(n, tuple):
                if not (isinstance(s, tuple) and len(s) == len(n)):
                    raise ValueError(
                        f"joint block {n}: sizes must be a matching tuple"
                    )
                self.blocks.append((tuple(n), tuple(int(x) for x in s), k))
            else:
                self.blocks.append((n, int(s), k))
        names = [x for n, _, _ in self.blocks
                 for x in (n if isinstance(n, tuple) else (n,))]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate block names in {names}")
        # flat (name, size) layout for storage/state, declaration order
        self._layout = []
        for n, s, _ in self.blocks:
            if isinstance(n, tuple):
                self._layout.extend(zip(n, s))
            else:
                self._layout.append((n, s))
        self.n_chains = int(n_chains)
        self.n_params = sum(s for _, s in self._layout)
        self.dtype = dtype
        self._logp = logp_fn
        self._key = jax.random.key(seed)
        self.state = None  # dict name -> (C, size)
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
        # byte budgeting alone can make launches minutes-long when a sweep
        # is heavyweight (PGAS / FFBS blocks run a whole filter per step);
        # cap the per-launch step count for those schemes
        self._max_chunk_steps = (
            None if max_chunk_steps is None else max(1, int(max_chunk_steps))
        )
        self._run_cache = {}

    # -- state plumbing ------------------------------------------------------

    def init(self, values):
        """``values``: {name: (size,) or (C, size)} initial positions."""
        state = {}
        for name, size in self._layout:
            if name not in values:
                raise ValueError(f"missing init for block {name!r}")
            v = jnp.asarray(values[name], self.dtype)
            if v.ndim == 1:
                v = jnp.broadcast_to(v[None, :], (self.n_chains, size))
            if v.shape != (self.n_chains, size):
                raise ValueError(
                    f"block {name!r}: init shape {v.shape} != "
                    f"({self.n_chains}, {size})"
                )
            if self._chain_sharding is not None:
                v = jax.device_put(v, self._chain_sharding)
            state[name] = v
        self.state = state
        return self

    def _constrain(self, state):
        if self._chain_sharding is None:
            return state
        c = lambda x: jax.lax.with_sharding_constraint(
            x, self._chain_sharding
        )
        return {k: c(v) for k, v in state.items()}

    # -- one sweep (unbatched; vmapped over chains) ---------------------------

    def _sweep(self, key, values):
        for i, (name, _, kernel) in enumerate(self.blocks):
            sub = jax.random.fold_in(key, i)
            values = dict(values)
            if isinstance(name, tuple):
                others = {n: v for n, v in values.items()
                          if n not in name}
                new = kernel.step(
                    sub, tuple(values[n] for n in name), others
                )
                values.update(zip(name, new))
            else:
                others = {n: v for n, v in values.items() if n != name}
                values[name] = kernel.step(sub, values[name], others)
        return values

    def _flat(self, state):
        return jnp.concatenate(
            [state[n] for n, _ in self._layout], axis=1
        )

    def _run_scan(self, state, key, n_store, thin):
        def body(carry, _):
            state, key = carry

            def inner(j, sk):
                s, k = sk
                k, sub = jax.random.split(k)
                keys = jax.random.split(sub, self.n_chains)
                s = self._constrain(jax.vmap(self._sweep)(keys, s))
                return (s, k)

            state, key = jax.lax.fori_loop(0, thin, inner, (state, key))
            flat = self._flat(state)
            if self._logp is not None:
                lp = jax.vmap(
                    lambda row: self._logp(self._unflatten(row))
                )(flat)
            else:
                lp = jnp.zeros((self.n_chains,), self.dtype)
            if self._chain_sharding is not None:
                # the stored lp column must shard WITH the chains axis, or
                # multi-host stores fetch mismatched widths
                from mcmcpp_tpu.parallel.mesh import vector_sharding

                lp = jax.lax.with_sharding_constraint(
                    lp, vector_sharding(self._chain_sharding)
                )
            return (state, key), (flat, lp)

        (state, _), (pos, lp) = jax.lax.scan(
            body, (state, key), length=n_store
        )
        return state, pos, lp

    def _unflatten(self, row):
        out, i = {}, 0
        for name, size in self._layout:
            out[name] = row[i : i + size]
            i += size
        return out

    # -- driver ----------------------------------------------------------

    def run(self, n_steps, thin=1):
        """Advance ``n_steps`` sweeps, storing every thin-th flattened
        state. Returns False on chain byte-cap (EndOfChain)."""
        if self.state is None:
            raise RuntimeError("call init first")
        thin = int(thin)
        n_store = int(n_steps) // thin
        leftover = int(n_steps) - n_store * thin
        chunk = default_chunk_steps(self.n_chains, self.n_params, self.dtype)
        if self._max_chunk_steps is not None:
            chunk = min(chunk, self._max_chunk_steps)

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
            self.state, pos, lp = fn(self.state, run_key)
            return (pos, lp)

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

    def get_block(self, name, burn_in=0, thin=1, flat=False):
        """Samples for one named block, sliced from the flat store."""
        i = 0
        for n, size in self._layout:
            if n == name:
                s = self.get_samples(burn_in=burn_in, thin=thin, flat=flat)
                return s[..., i : i + size]
            i += size
        raise KeyError(name)
