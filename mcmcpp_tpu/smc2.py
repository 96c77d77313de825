"""SMC² — online joint parameter + state inference for state-space models.

Chopin, Jacob & Papaspiliopoulos (2013, JRSS-B). The exact nesting of the
framework's two sequential layers: an IBIS-style θ-level particle system
(:mod:`mcmcpp_tpu.ibis`) whose per-datum likelihood increments are
estimated by one bootstrap particle filter PER θ-particle
(:func:`mcmcpp_tpu.particle.particle_filter` logic, inlined here so the
x-systems persist across observations). Each arriving observation y_t:

1. advances every θ-particle's x-system one filter step, yielding the
   unbiased increment ``p̂(y_t | y_{1:t-1}, θ^m)``;
2. reweights the θ-cloud by those increments (the prequential evidence
   decomposition comes for free, exactly as in IBIS);
3. when the θ-ESS degrades, resamples whole (θ, x-system) pairs and
   rejuvenates each θ through a PMMH exchange move: propose θ', run a
   FRESH filter over the absorbed prefix y_{1:t}, accept on the
   pseudo-marginal ratio, and on acceptance adopt the fresh x-system so
   filtering can continue (Chopin et al. 2013 §3.2 — the carried
   estimate for the incumbent, the fresh estimate for the proposal,
   keeps the extended-space target exactly invariant).

Validity: the algorithm is a standard SMC sampler on the extended space
of (θ, all x-particles, ancestors), so every posterior expectation and
the evidence estimate are consistent for ANY n_particles ≥ 1; n_x only
controls the estimator variance (and hence move acceptance).

No reference counterpart (jmatta1/MCMCpp has no sequential machinery at
all — its model surface is the scalar ``calcLogPostProb``,
``MCMCpp/EnsembleSampler.h:80-96``); north-star scope completing the
online corner of the time-series layer: exact-linear (lgss) × offline
(PMMH/PGAS) × online-iid (IBIS) × online-SSM (this module).

Accelerator-first shape
---------------
The device sees the full ``(M, Nx, D)`` block every step: the advance is
one vmapped filter step over θ-particles (fused elementwise ops + a
``searchsorted`` gather), and the rejuvenation move vmaps WHOLE masked
filters over the θ axis — a single ``lax.scan`` over the padded buffer
per MH step, all M filters in flight at once. The observation buffer is
padded to power-of-two capacities so a whole stream compiles O(log T)
stage programs (the IBIS trick); the move's filter scan runs over the
capacity with ``row < t`` masking, so its cost is O(capacity) regardless
of t. The resample-or-move decision is a ``lax.cond`` whose untaken
branch never executes. The θ axis shards over a mesh like every other
engine (x-particles stay device-local to their θ — no cross-device
traffic inside a filter step).
"""

from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from mcmcpp_tpu.particle import StateSpaceModel
from mcmcpp_tpu.smc import ess_from_log_weights, systematic_resample


class SMC2State(NamedTuple):
    theta: jax.Array         # (M, P)
    log_prior: jax.Array     # (M,)
    loglik_hat: jax.Array    # (M,) carried PF estimate log p̂(y_{1:t}|θ)
    xs: jax.Array            # (M, Nx, D) per-θ state particles
    x_logw: jax.Array        # (M, Nx) normalized x log-weights
    log_w: jax.Array         # (M,) θ-level running log weights
    log_evidence: jax.Array  # () running log p̂(y_{1:t})
    n_included: jax.Array    # () int32 observations absorbed


class SMC2Sampler:
    """Online SSM inference: posterior over θ (and filtered states) after
    every observation, plus the prequential evidence decomposition.

    ssm : :class:`~mcmcpp_tpu.particle.StateSpaceModel` whose hooks read
        θ as a flat ``(P,)`` vector (the PMMH convention);
        ``trans_logpdf`` is not needed.
    log_prior_fn : (P,) -> scalar, JAX-traceable (−inf outside support;
        the filter must still be safe to trace there).
    prior_sample_fn : (key, n) -> (n, P) exact prior draws.
    n_theta / n_particles : θ-cloud size M / x-particles per θ (Nx).
        Rule of thumb: grow ``n_particles`` with t so the likelihood-
        estimate variance stays O(1); a fixed Nx with std ≈ 1–2 nats at
        the posterior mode keeps rejuvenation acceptance healthy.
    n_mcmc : PMMH rejuvenation steps per resample event.
    target_ess : θ-resample trigger (fraction of M).
    ess_frac_x : x-level adaptive-resample trigger (fraction of Nx).
    """

    def __init__(self, ssm: StateSpaceModel, log_prior_fn, prior_sample_fn,
                 n_theta, n_params, n_particles=128, n_mcmc=3,
                 target_ess=0.5, ess_frac_x=0.5, rw_scale=1.0, seed=0,
                 dtype=jnp.float32, mesh=None, grow_particles=False,
                 grow_threshold=0.15, max_particles=None,
                 max_chunk_steps=32):
        """``grow_particles=True`` enables the Chopin et al. (2013, §3.5)
        exchange step: when a rejuvenation sweep's mean PMMH acceptance
        falls below ``grow_threshold`` (evidence the likelihood-estimate
        variance has outgrown Nx), every θ-particle's x-system is
        replaced by a FRESH filter at 2·Nx over the absorbed prefix and
        the θ-weights are importance-corrected by the new/old estimate
        ratio — exactly valid, and it keeps acceptance healthy as t
        grows instead of letting the sampler silently degenerate.
        ``max_particles`` caps the doubling (default 16× the start).

        ``max_chunk_steps``: observations fused per launch when
        ``grow_particles`` is off (bitwise-identical to per-row; one
        dispatch+sync per chunk). Lower it if a chunk's worst case
        (every stage rejuvenating) makes one launch too long: the cap
        bounds per-launch work. ``None``/1 disables fusing."""
        self.ssm = ssm
        self.log_prior_fn = log_prior_fn
        self.prior_sample_fn = prior_sample_fn
        self.m = int(n_theta)
        self.n_params = int(n_params)
        self.n_x = int(n_particles)
        self.n_mcmc = int(n_mcmc)
        self.target_ess = float(target_ess)
        self.ess_frac_x = float(ess_frac_x)
        self.rw_scale = float(rw_scale)
        self.dtype = dtype
        self._key = jax.random.key(seed)
        self._theta_sharding = None
        self._xs_sharding = None
        if mesh is not None:
            from jax.sharding import NamedSharding, PartitionSpec

            from mcmcpp_tpu.parallel.mesh import walker_sharding

            if self.m % mesh.size != 0:
                raise ValueError(
                    f"n_theta={self.m} not divisible by mesh {mesh.size}"
                )
            self._theta_sharding = walker_sharding(mesh)
            self._xs_sharding = NamedSharding(
                mesh, PartitionSpec(self._theta_sharding.spec[0], None, None)
            )
        self.state = None
        self._ys = None            # absorbed (T, E) observation buffer
        self.n_resamples = 0
        self.log_evidence_trace = []   # per-obs log p̂(y_t | y_{1:t-1})
        self._stage_cache = {}         # capacity -> jitted stage program
        self.grow_particles = bool(grow_particles)
        self.grow_threshold = float(grow_threshold)
        self.max_particles = (16 * self.n_x if max_particles is None
                              else int(max_particles))
        self.n_growths = 0
        self.last_rejuvenation_accept = float("nan")
        self._grow_cache = {}          # new_nx -> jitted exchange step
        self._chunk_size = (1 if max_chunk_steps is None
                            else max(1, int(max_chunk_steps)))
        self._chunk_cache = {}         # capacity -> jitted chunk program

    # -- internals -----------------------------------------------------------

    def _constrain(self, state):
        if self._theta_sharding is None:
            return state
        from mcmcpp_tpu.parallel.mesh import vector_sharding

        vec = vector_sharding(self._theta_sharding)
        mat = vector_sharding(self._xs_sharding)  # (M, Nx) rows over mesh
        c = lambda s: lambda x: jax.lax.with_sharding_constraint(x, s)
        return SMC2State(
            c(self._theta_sharding)(state.theta),
            c(vec)(state.log_prior), c(vec)(state.loglik_hat),
            c(self._xs_sharding)(state.xs), c(mat)(state.x_logw),
            c(vec)(state.log_w),
            state.log_evidence, state.n_included,
        )

    def _x_dim(self):
        shape = jax.eval_shape(
            lambda k: self.ssm.init_sample(
                k, self.n_x, jnp.zeros((self.n_params,), self.dtype)
            ),
            jax.random.key(0),
        ).shape
        if len(shape) != 2 or shape[0] != self.n_x:
            raise ValueError(
                f"ssm.init_sample must return (n, D), traced {shape}"
            )
        return int(shape[1])

    def _pf_step(self, k_rs, k_prop, x, lw, y, t, theta, n):
        """Shared bootstrap transition (adaptive systematic resample →
        propagate → weight) used by the live advance, the rejuvenation
        re-filter, and the grow step — one copy so the trigger/weight
        algebra cannot drift between them.
        Returns (x', normalized lw', log-increment)."""
        logn = jnp.log(jnp.asarray(float(n)))
        ess = ess_from_log_weights(lw)
        idx = systematic_resample(k_rs, lw, n)
        do_rs = ess < self.ess_frac_x * n
        idx = jnp.where(do_rs, idx, jnp.arange(n, dtype=jnp.int32))
        xr = jnp.take(x, idx, axis=0)
        lwr = jnp.where(do_rs, jnp.full((n,), -logn, lw.dtype), lw)
        xn = self.ssm.trans_sample(k_prop, xr, t, theta).astype(x.dtype)
        ll = self.ssm.obs_logpdf(y, xn, t, theta)
        incr = jax.scipy.special.logsumexp(lwr + ll)
        return xn, lwr + ll - incr, incr

    def _advance_one(self, key, theta, x, lw, y, t):
        """One filter step for one θ-particle. Handles t == 0 (fresh
        x-system from the initial law) and t ≥ 1 (adaptive-resample +
        propagate + weight) in a single program via ``lax.cond``.
        Returns (x', lw', incr) with incr = log p̂(y_t | y_{1:t-1}, θ)."""
        n = self.n_x
        logn = jnp.log(jnp.asarray(float(n)))
        k_init, k_rs, k_prop = jax.random.split(key, 3)

        def first(_):
            x0 = self.ssm.init_sample(k_init, n, theta).astype(x.dtype)
            ll = self.ssm.obs_logpdf(y, x0, 0, theta)
            norm = jax.scipy.special.logsumexp(ll)
            return x0, ll - norm, (norm - logn).astype(lw.dtype)

        def later(_):
            xn, lwn, incr = self._pf_step(k_rs, k_prop, x, lw, y, t,
                                          theta, n)
            return xn, lwn, incr.astype(lw.dtype)

        return jax.lax.cond(t == jnp.int32(0), first, later, None)

    def _masked_pf(self, key, theta, ys, n_incl, n=None):
        """Fresh bootstrap filter over rows [0, n_incl) of the PADDED
        buffer: explicit step 0 + one scan over rows 1..capacity−1 with
        ``row < n_incl`` masking (state and increments frozen on padding
        rows). Returns (cum_loglik, x_final, lw_final) so an accepted
        rejuvenation proposal can keep filtering. ``n`` overrides the
        particle count (the grow step traces at the NEW size)."""
        n = self.n_x if n is None else int(n)
        logn = jnp.log(jnp.asarray(float(n)))
        k0, k_scan = jax.random.split(key)
        x = self.ssm.init_sample(k0, n, theta).astype(self.dtype)
        ll0 = self.ssm.obs_logpdf(ys[0], x, 0, theta)
        norm0 = jax.scipy.special.logsumexp(ll0)
        lw = ll0 - norm0
        cum0 = norm0 - logn

        def body(carry, inp):
            x, lw, key = carry
            y, i = inp
            key, k_rs, k_prop = jax.random.split(key, 3)
            valid = i < n_incl
            xn, lwn, incr = self._pf_step(k_rs, k_prop, x, lw, y, i,
                                          theta, n)
            x = jnp.where(valid, xn, x)
            lw = jnp.where(valid, lwn, lw)
            return (x, lw, key), jnp.where(valid, incr, 0.0)

        cap = ys.shape[0]
        (x, lw, _), incrs = jax.lax.scan(
            body, (x, lw, k_scan),
            (ys[1:], jnp.arange(1, cap, dtype=jnp.int32)),
        )
        return (cum0 + jnp.sum(incrs)).astype(self.dtype), x, lw

    def _stage_impl(self, key, state, ys, t):
        """Absorb observation row ``t`` (traced): advance all x-systems,
        reweight the θ-cloud, then cond(resample + PMMH rejuvenation)."""
        state = self._constrain(state)
        m = self.m
        k_adv, k_res, k_move = jax.random.split(key, 3)
        y = jnp.take(ys, t, axis=0)

        xs, x_logw, incr = jax.vmap(
            self._advance_one, in_axes=(0, 0, 0, 0, None, None)
        )(jax.random.split(k_adv, m), state.theta, state.xs,
          state.x_logw, y, t)

        lw_old = state.log_w
        stage_logz = (
            jax.scipy.special.logsumexp(lw_old + incr)
            - jax.scipy.special.logsumexp(lw_old)
        )
        log_w = lw_old + incr
        loglik_hat = state.loglik_hat + incr
        ess = ess_from_log_weights(log_w)
        n_incl = t + jnp.int32(1)

        def do_move(args):
            theta, log_prior, loglik_hat, xs, x_logw, log_w = args
            idx = systematic_resample(k_res, log_w, m)
            theta = theta[idx]
            log_prior = log_prior[idx]
            loglik_hat = loglik_hat[idx]
            xs = xs[idx]
            x_logw = x_logw[idx]
            mean = jnp.mean(theta, axis=0)
            centered = theta - mean
            cov = centered.T @ centered / (m - 1.0)
            # degenerate-cloud guard (PMMH tune()'s spread check, trace-
            # safe form): a collapsed cloud (resampling duplicated one
            # survivor) would yield ~zero proposals — acceptance ≈ 1,
            # rejuvenation a no-op, the collapse permanent. Floor the
            # proposal at a small isotropic scale instead.
            degenerate = jnp.trace(cov) < self.n_params * 1e-10
            cov = cov + jnp.where(degenerate, 1e-2, 1e-8) * jnp.eye(
                self.n_params, dtype=cov.dtype
            )
            chol = jnp.linalg.cholesky(
                (self.rw_scale ** 2) * (2.38 ** 2 / self.n_params) * cov
            )

            def mh_step(i, carry):
                theta, log_prior, loglik_hat, xs, x_logw, n_acc, key = carry
                key, k_prop, k_pf, k_u = jax.random.split(key, 4)
                z = jax.random.normal(k_prop, theta.shape, theta.dtype)
                prop = theta + z @ chol.T
                lp_new = jax.vmap(self.log_prior_fn)(prop).astype(self.dtype)
                ll_new, x_new, xw_new = jax.vmap(
                    self._masked_pf, in_axes=(0, 0, None, None)
                )(jax.random.split(k_pf, m), prop, ys, n_incl)
                log_ratio = (lp_new + ll_new) - (log_prior + loglik_hat)
                u = jax.random.uniform(k_u, (m,), minval=1e-37)
                ok = (jnp.log(u) < log_ratio) & jnp.isfinite(lp_new) \
                    & jnp.isfinite(ll_new)
                theta = jnp.where(ok[:, None], prop, theta)
                log_prior = jnp.where(ok, lp_new, log_prior)
                loglik_hat = jnp.where(ok, ll_new, loglik_hat)
                xs = jnp.where(ok[:, None, None], x_new, xs)
                x_logw = jnp.where(ok[:, None], xw_new, x_logw)
                n_acc = n_acc + jnp.sum(ok.astype(jnp.int32))
                return theta, log_prior, loglik_hat, xs, x_logw, n_acc, key

            (theta, log_prior, loglik_hat, xs, x_logw, n_acc,
             _) = jax.lax.fori_loop(
                0, self.n_mcmc, mh_step,
                (theta, log_prior, loglik_hat, xs, x_logw,
                 jnp.zeros((), jnp.int32), k_move),
            )
            acc_rate = n_acc / jnp.asarray(
                float(m * max(self.n_mcmc, 1)), jnp.float32
            )
            return (theta, log_prior, loglik_hat, xs, x_logw,
                    jnp.zeros(m, log_w.dtype), jnp.ones((), jnp.int32),
                    acc_rate)

        def no_move(args):
            theta, log_prior, loglik_hat, xs, x_logw, log_w = args
            return (theta, log_prior, loglik_hat, xs, x_logw, log_w,
                    jnp.zeros((), jnp.int32), jnp.full((), jnp.nan))

        (theta, log_prior, loglik_hat, xs, x_logw, log_w, moved,
         acc_rate) = jax.lax.cond(
            ess < self.target_ess * m,
            do_move, no_move,
            (state.theta, state.log_prior, loglik_hat, xs, x_logw, log_w),
        )
        new_state = SMC2State(
            theta, log_prior, loglik_hat, xs, x_logw, log_w,
            state.log_evidence + stage_logz, n_incl,
        )
        return self._constrain(new_state), stage_logz, moved, acc_rate

    def _grow_impl(self, key, state, ys, new_nx):
        """Chopin et al. (2013, §3.5) exchange step: replace every
        θ-particle's x-system by a FRESH filter at ``new_nx`` over the
        absorbed prefix, importance-correcting the θ-weights by the
        new/old likelihood-estimate ratio. Exactly valid for any Nx."""
        ll_new, x_new, xw_new = jax.vmap(
            lambda k, th: self._masked_pf(
                k, th, ys, state.n_included, n=new_nx
            )
        )(jax.random.split(key, self.m), state.theta)
        return SMC2State(
            state.theta, state.log_prior, ll_new, x_new, xw_new,
            state.log_w + (ll_new - state.loglik_hat),
            state.log_evidence, state.n_included,
        )

    # -- public API ----------------------------------------------------------

    def init(self):
        self._key, k = jax.random.split(self._key)
        theta = jnp.asarray(self.prior_sample_fn(k, self.m), self.dtype)
        if theta.shape != (self.m, self.n_params):
            raise ValueError(
                f"prior_sample returned {theta.shape}, expected "
                f"{(self.m, self.n_params)}"
            )
        if self._theta_sharding is not None:
            theta = jax.device_put(theta, self._theta_sharding)
        lp = jax.vmap(self.log_prior_fn)(theta).astype(self.dtype)
        d = self._x_dim()
        n = self.n_x
        self.state = self._constrain(SMC2State(
            theta, lp,
            jnp.zeros(self.m, self.dtype),
            jnp.zeros((self.m, n, d), self.dtype),
            jnp.full((self.m, n), -np.log(n), self.dtype),
            jnp.zeros(self.m, self.dtype),
            jnp.zeros((), jnp.float32), jnp.zeros((), jnp.int32),
        ))
        return self

    def update(self, ys):
        """Absorb observations ``ys`` (shape (T_new, E) or (T_new,)) one
        at a time. Call repeatedly as the stream grows — the posterior,
        filtered states, and prequential evidence continue from the
        current systems. Returns self."""
        if self.state is None:
            self.init()
        ys = jnp.asarray(ys, self.dtype)
        if ys.ndim == 1:
            ys = ys[:, None]
        start0 = 0 if self._ys is None else self._ys.shape[0]
        self._ys = (ys if self._ys is None
                    else jnp.concatenate([self._ys, ys], axis=0))
        n_rows = self._ys.shape[0]
        # IBIS capacity trick: pad to the next power of two so a stream
        # compiles O(log T) programs; padding rows are masked everywhere
        from mcmcpp_tpu.utils.buffers import pad_to_capacity

        padded, capacity = pad_to_capacity(self._ys, n_rows)
        t = start0
        # chunked path: CHUNK observations per launch (a lax.scan whose
        # body is the per-row stage with the IDENTICAL key-split chain,
        # so chunked == per-row bit for bit) — one dispatch + one host
        # sync per CHUNK instead of per row. Disabled under
        # grow_particles (the grow decision reads each row's
        # rejuvenation acceptance on the host).
        if not self.grow_particles and self._chunk_size > 1:
            chunk = self._chunk_size
            fn = self._chunk_cache.get(capacity)
            if fn is None:
                fn = jax.jit(
                    lambda key, st, ys, t0, c=chunk:
                    self._chunk_impl(key, st, ys, t0, c)
                )
                self._chunk_cache[capacity] = fn
            while n_rows - t >= chunk:
                self._key, self.state, logzs, moveds, accs = fn(
                    self._key, self.state, padded,
                    jnp.asarray(t, jnp.int32),
                )
                self.log_evidence_trace.extend(
                    float(v) for v in np.asarray(logzs)
                )
                moveds = np.asarray(moveds)
                self.n_resamples += int(moveds.sum())
                if moveds.any():
                    self.last_rejuvenation_accept = float(
                        np.asarray(accs)[moveds.astype(bool)][-1]
                    )
                t += chunk
        stage = self._stage_cache.get(capacity)
        if stage is None:
            stage = jax.jit(self._stage_impl)
            self._stage_cache[capacity] = stage
        while t < n_rows:
            self._key, k = jax.random.split(self._key)
            self.state, stage_logz, moved, acc_rate = stage(
                k, self.state, padded, jnp.asarray(t, jnp.int32)
            )
            self.log_evidence_trace.append(float(stage_logz))
            if int(moved):
                self.n_resamples += 1
                self.last_rejuvenation_accept = float(acc_rate)
                if (self.grow_particles
                        and self.last_rejuvenation_accept
                        < self.grow_threshold
                        and 2 * self.n_x <= self.max_particles):
                    self._grow(padded)
            t += 1
        return self

    def _chunk_impl(self, key, state, ys, t_start, chunk):
        """``chunk`` consecutive stages in one program (bitwise
        identical to per-row stage calls — see
        :func:`mcmcpp_tpu.utils.buffers.chunked_stage_scan`)."""
        from mcmcpp_tpu.utils.buffers import chunked_stage_scan

        def stage(k, st, r):
            st, logz, moved, acc = self._stage_impl(k, st, ys,
                                                    t_start + r)
            return st, (logz, moved, acc)

        key, state, (logzs, moveds, accs) = chunked_stage_scan(
            stage, key, state, chunk
        )
        return key, state, logzs, moveds, accs

    def _grow(self, padded):
        new_nx = 2 * self.n_x
        fn = self._grow_cache.get(new_nx)
        if fn is None:
            fn = jax.jit(
                lambda key, st, ys, n=new_nx: self._grow_impl(
                    key, st, ys, n
                )
            )
            self._grow_cache[new_nx] = fn
        self._key, k = jax.random.split(self._key)
        self.state = self._constrain(fn(k, self.state, padded))
        self.n_x = new_nx
        self.n_growths += 1

    # -- readout -------------------------------------------------------------

    @property
    def log_evidence(self):
        """Running log p̂(y_{1:t}) (prequential sum; consistent in M)."""
        if self.state is None:
            raise RuntimeError("call update() first")
        return float(self.state.log_evidence)

    def _theta_weights(self):
        lw = np.asarray(self.state.log_w, np.float64)
        w = np.exp(lw - lw.max())
        return w / w.sum()

    def posterior(self, n_draws=None, seed=0):
        """Weight-resampled θ draws from the current cloud."""
        if self.state is None:
            raise RuntimeError("call update() first")
        w = self._theta_weights()
        rng = np.random.default_rng(seed)
        n = self.m if n_draws is None else int(n_draws)
        idx = rng.choice(self.m, size=n, p=w)
        return np.asarray(self.state.theta)[idx]

    def moments(self):
        """Weighted posterior mean and covariance of θ."""
        if self.state is None:
            raise RuntimeError("call update() first")
        x = np.asarray(self.state.theta, np.float64)
        w = self._theta_weights()
        mean = w @ x
        centered = x - mean
        cov = (centered * w[:, None]).T @ centered / (1.0 - (w ** 2).sum())
        return mean, cov

    def state_estimate(self):
        """E[x_t | y_{1:t}] marginalized over θ: the doubly-weighted
        particle mean Σ_m w_m Σ_i w_{mi} x_{mi} — the Bayesian filter
        output a pure state-tracking user wants."""
        if self.state is None:
            raise RuntimeError("call update() first")
        w = self._theta_weights()
        xw = np.asarray(self.state.x_logw, np.float64)
        xw = np.exp(xw - xw.max(axis=1, keepdims=True))
        xw /= xw.sum(axis=1, keepdims=True)
        xs = np.asarray(self.state.xs, np.float64)
        per_theta = np.einsum("mi,mid->md", xw, xs)
        return w @ per_theta
