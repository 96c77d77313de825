"""IBIS — Iterated Batch Importance Sampling (data-tempered SMC).

Chopin (2002, Biometrika); Chopin & Papaspiliopoulos (2020, ch. 17).
Where :class:`~mcmcpp_tpu.smc.SMCSampler` anneals a LIKELIHOOD EXPONENT
β: 0 → 1 on the full dataset, IBIS anneals the DATASET itself: particles
track the sequence of partial posteriors

    π_t(θ) ∝ p(θ) · Π_{i<t} p(y_i | θ),

reweighting by each arriving batch's likelihood, resampling + MCMC-moving
only when the ESS degrades. That buys what likelihood tempering cannot:

- ONLINE inference — the posterior is available after every batch, and
  new data extends a finished run (call :meth:`update` again) instead of
  restarting;
- the PREQUENTIAL evidence decomposition — each increment is
  log p(y_batch | y_past), so the running log-evidence doubles as an
  exactly-decomposed predictive score (Bayes-factor traces, change-point
  flagging) rather than one end-of-run number.

Accelerator-first shape: all per-stage work is STATIC-SHAPED masked evaluation
over the absorbed data buffer — the new-batch reweight uses a
``[start, start+take)`` row mask, the move kernel's proposal re-scoring
uses the ``rows < n_included`` prefix mask, and the resample-or-not
decision is a `lax.cond` whose untaken branch never executes. The
buffer is padded to power-of-two capacities (the only static), so a
whole stream compiles O(log T) stage programs — not one per update()
or per stage. The move kernel is the classic IBIS choice: ``n_mcmc`` adaptive
Gaussian random-walk MH steps with proposal covariance 2.38²/P × the
post-resample particle cloud's (Chopin 2002 §4.1 — the covariance is
measurable wrt the pre-move state, so π_t-invariance is exact). The
particle axis shards over a mesh like every other engine.

No reference counterpart (the reference has no SMC at all) — this
completes the evidence/SMC layer the same way waste-free and flow
mutation did. Cross-engine agreement with likelihood-tempered SMC and
the conjugate closed form is oracle-tested (tests/test_ibis.py).
"""

from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from mcmcpp_tpu.smc import ess_from_log_weights, systematic_resample


class IBISState(NamedTuple):
    particles: jax.Array     # (n, P)
    log_prior: jax.Array     # (n,)
    loglik_cum: jax.Array    # (n,) Σ log p(y_i|θ) over included rows
    log_w: jax.Array         # (n,) running (unnormalized) log weights
    log_evidence: jax.Array  # () running log p(y_{1:t})
    n_included: jax.Array    # () int32 rows absorbed so far


class IBISSampler:
    """Online posterior + prequential evidence over a data stream.

    log_prior_fn : (P,) -> scalar, JAX-traceable.
    loglike_point_fn : (theta (P,), row pytree) -> scalar log p(y_i | θ)
        for ONE datum (vmapped over particles and rows internally).
    prior_sample_fn : (key, n) -> (n, P) exact prior draws.
    batch_size : rows absorbed per stage (1 = fully sequential IBIS;
        larger batches amortize the move cost).
    n_mcmc : RWM move steps per resample event.
    target_ess : resample when ESS/n drops below this (default 0.5).
    """

    def __init__(self, log_prior_fn, loglike_point_fn, prior_sample_fn,
                 n_particles, n_params, batch_size=1, n_mcmc=5,
                 target_ess=0.5, rw_scale=1.0, seed=0,
                 dtype=jnp.float32, mesh=None, max_chunk_steps=32):
        """``max_chunk_steps``: full-size stages fused per launch (one
        dispatch + one host sync per chunk instead of per stage, with a
        bitwise-identical key chain — results never change; the SMC²
        pattern). Lower it if a chunk's worst case (every stage
        resampling+moving, each move re-scoring the WHOLE absorbed
        prefix — the move cost grows O(t)) makes one launch too long:
        the cap bounds per-launch work. ``None``/1 disables fusing."""
        self.log_prior_fn = log_prior_fn
        self.loglike_point_fn = loglike_point_fn
        self.prior_sample_fn = prior_sample_fn
        self.n = int(n_particles)
        self.n_params = int(n_params)
        self.batch_size = int(batch_size)
        if self.batch_size < 1:
            raise ValueError("batch_size must be >= 1")
        self.n_mcmc = int(n_mcmc)
        self.target_ess = float(target_ess)
        self.rw_scale = float(rw_scale)
        self.dtype = dtype
        self._key = jax.random.key(seed)
        self._particle_sharding = None
        if mesh is not None:
            from mcmcpp_tpu.parallel.mesh import walker_sharding

            if self.n % mesh.size != 0:
                raise ValueError(
                    f"n_particles={self.n} not divisible by mesh "
                    f"{mesh.size}"
                )
            self._particle_sharding = walker_sharding(mesh)
        self.state = None
        self._data = None  # absorbed-stream buffer (pytree, leading N)
        self.n_resamples = 0
        self.log_evidence_trace = []  # per-stage log p(y_batch | y_past)
        self._stage_cache = {}  # capacity -> jitted stage
        self._chunk_size = (1 if max_chunk_steps is None
                            else max(1, int(max_chunk_steps)))
        self._chunk_cache = {}  # capacity -> jitted fused-chunk program

    # -- internals -----------------------------------------------------------

    def _constrain(self, state):
        if self._particle_sharding is None:
            return state
        from mcmcpp_tpu.parallel.mesh import vector_sharding

        vec = vector_sharding(self._particle_sharding)
        c = lambda x: jax.lax.with_sharding_constraint(
            x, self._particle_sharding
        )
        v = lambda x: jax.lax.with_sharding_constraint(x, vec)
        return IBISState(
            c(state.particles), v(state.log_prior), v(state.loglik_cum),
            v(state.log_w), state.log_evidence, state.n_included,
        )

    def _masked_loglik(self, particles, data, mask):
        """(n,) Σ over masked rows of log p(y_i | θ) per particle."""
        def one(theta):
            per_row = jax.vmap(
                lambda row: self.loglike_point_fn(theta, row)
            )(data)
            return jnp.sum(jnp.where(mask, per_row, 0.0))

        return jax.vmap(one)(particles)

    def _stage_impl(self, key, state, data, start, take):
        """Absorb rows [start, start+take): reweight -> cond(resample+move).

        start/take are traced — ONE program per buffer length serves
        every stage of an update() sweep.
        """
        state = self._constrain(state)
        n_rows = jax.tree.leaves(data)[0].shape[0]
        rows = jnp.arange(n_rows)
        new_mask = (rows >= start) & (rows < start + take)
        incl_after = rows < (start + take)

        incr = self._masked_loglik(state.particles, data, new_mask)
        lw_old = state.log_w
        # prequential increment log p(y_batch | y_past) under the current
        # weighted particle approximation
        stage_logz = (
            jax.scipy.special.logsumexp(lw_old + incr)
            - jax.scipy.special.logsumexp(lw_old)
        )
        log_w = lw_old + incr
        loglik_cum = state.loglik_cum + incr
        ess = ess_from_log_weights(log_w)
        k_res, k_move = jax.random.split(key)

        def do_resample(args):
            particles, log_prior, loglik_cum, log_w = args
            idx = systematic_resample(k_res, log_w, self.n)
            particles = particles[idx]
            log_prior = log_prior[idx]
            loglik_cum = loglik_cum[idx]
            mean = jnp.mean(particles, axis=0)
            centered = particles - mean
            cov = centered.T @ centered / (self.n - 1.0)
            cov = cov + 1e-8 * jnp.eye(self.n_params, dtype=cov.dtype)
            chol = jnp.linalg.cholesky(
                (self.rw_scale ** 2) * (2.38 ** 2 / self.n_params) * cov
            )

            def mh_step(i, carry):
                particles, log_prior, loglik_cum, key = carry
                key, k_prop, k_acc = jax.random.split(key, 3)
                z = jax.random.normal(
                    k_prop, particles.shape, particles.dtype
                )
                prop = particles + z @ chol.T
                lp_new = jax.vmap(self.log_prior_fn)(prop)
                ll_new = self._masked_loglik(prop, data, incl_after)
                log_ratio = (lp_new + ll_new) - (log_prior + loglik_cum)
                accept = (
                    jnp.log(jax.random.uniform(k_acc, (self.n,)))
                    < log_ratio
                )
                particles = jnp.where(accept[:, None], prop, particles)
                log_prior = jnp.where(accept, lp_new, log_prior)
                loglik_cum = jnp.where(accept, ll_new, loglik_cum)
                return particles, log_prior, loglik_cum, key

            particles, log_prior, loglik_cum, _ = jax.lax.fori_loop(
                0, self.n_mcmc, mh_step,
                (particles, log_prior, loglik_cum, k_move),
            )
            return (particles, log_prior, loglik_cum,
                    jnp.zeros(self.n, log_w.dtype),
                    jnp.ones((), jnp.int32))

        def no_resample(args):
            particles, log_prior, loglik_cum, log_w = args
            return (particles, log_prior, loglik_cum, log_w,
                    jnp.zeros((), jnp.int32))

        particles, log_prior, loglik_cum, log_w, resampled = jax.lax.cond(
            ess < self.target_ess * self.n,
            do_resample, no_resample,
            (state.particles, state.log_prior, loglik_cum, log_w),
        )
        new_state = IBISState(
            particles, log_prior, loglik_cum, log_w,
            state.log_evidence + stage_logz,
            state.n_included + take.astype(jnp.int32),
        )
        return self._constrain(new_state), stage_logz, resampled, ess

    # -- public API ----------------------------------------------------------

    def init(self):
        self._key, k = jax.random.split(self._key)
        particles = jnp.asarray(self.prior_sample_fn(k, self.n), self.dtype)
        if particles.shape != (self.n, self.n_params):
            raise ValueError(
                f"prior_sample returned {particles.shape}, expected "
                f"{(self.n, self.n_params)}"
            )
        if self._particle_sharding is not None:
            particles = jax.device_put(particles, self._particle_sharding)
        lp = jax.vmap(self.log_prior_fn)(particles)
        self.state = self._constrain(IBISState(
            particles, lp,
            jnp.zeros(self.n, self.dtype), jnp.zeros(self.n, self.dtype),
            jnp.zeros((), jnp.float32), jnp.zeros((), jnp.int32),
        ))
        return self

    def update(self, data):
        """Absorb ``data`` (pytree, leading axis N) batch by batch.

        Call repeatedly as the stream grows — the posterior continues
        from the current state; earlier rows stay in the buffer because
        move events re-score proposals against the WHOLE absorbed prefix
        (classic IBIS; the O(t) move cost is amortized by the ESS
        trigger, which fires geometrically less often as t grows).
        Returns self.
        """
        if self.state is None:
            self.init()
        data = jax.tree.map(jnp.asarray, data)
        sizes = {int(x.shape[0]) for x in jax.tree.leaves(data)}
        if len(sizes) != 1:
            raise ValueError(f"data leaves disagree on leading axis: {sizes}")
        n_new = sizes.pop()
        start0 = (0 if self._data is None
                  else jax.tree.leaves(self._data)[0].shape[0])
        self._data = (data if self._data is None else jax.tree.map(
            lambda a, b: jnp.concatenate([a, b], axis=0), self._data, data
        ))
        n_rows = start0 + n_new
        # pad the buffer to the next power of two: the stage program is
        # traced per CAPACITY, not per length, so a long stream compiles
        # O(log T) programs instead of one per update() (padding rows are
        # never selected — every mask is bounded by start+take <= n_rows)
        from mcmcpp_tpu.utils.buffers import pad_to_capacity

        padded, capacity = pad_to_capacity(self._data, n_rows)
        start = start0
        bs = self.batch_size
        # fused path: chunk_size FULL stages per launch, replaying the
        # host loop's key-split chain bitwise (the SMC² chunking
        # pattern); the partial tail batch runs per-stage below
        if self._chunk_size > 1:
            chunk = self._chunk_size
            fn = self._chunk_cache.get(capacity)
            if fn is None:
                fn = jax.jit(
                    lambda key, st, data, s0, c=chunk:
                    self._chunk_impl(key, st, data, s0, c)
                )
                self._chunk_cache[capacity] = fn
            while n_rows - start >= chunk * bs:
                self._key, self.state, logzs, resampleds = fn(
                    self._key, self.state, padded,
                    jnp.asarray(start, jnp.int32),
                )
                self.log_evidence_trace.extend(
                    float(v) for v in np.asarray(logzs)
                )
                self.n_resamples += int(np.asarray(resampleds).sum())
                start += chunk * bs
        stage = self._stage_cache.get(capacity)
        if stage is None:
            stage = jax.jit(self._stage_impl)
            self._stage_cache[capacity] = stage
        while start < n_rows:
            take = min(bs, n_rows - start)
            self._key, k = jax.random.split(self._key)
            self.state, stage_logz, resampled, _ = stage(
                k, self.state, padded,
                jnp.asarray(start, jnp.int32), jnp.asarray(take, jnp.int32),
            )
            self.log_evidence_trace.append(float(stage_logz))
            self.n_resamples += int(resampled)
            start += take
        return self

    def _chunk_impl(self, key, state, data, start0, chunk):
        """``chunk`` consecutive FULL batches in one program (bitwise
        identical to per-stage calls — see
        :func:`mcmcpp_tpu.utils.buffers.chunked_stage_scan`)."""
        from mcmcpp_tpu.utils.buffers import chunked_stage_scan

        bs = jnp.int32(self.batch_size)

        def stage(k, st, r):
            st, logz, resampled, _ = self._stage_impl(
                k, st, data, start0 + r * bs, bs
            )
            return st, (logz, resampled)

        key, state, (logzs, resampleds) = chunked_stage_scan(
            stage, key, state, chunk
        )
        return key, state, logzs, resampleds

    # -- readout -------------------------------------------------------------

    @property
    def log_evidence(self):
        """Running log p(y_{1:t}) (prequential sum)."""
        if self.state is None:
            raise RuntimeError("call update() first")
        return float(self.state.log_evidence)

    def posterior(self, n_draws=None, seed=0):
        """Weight-resampled posterior draws from the current particles."""
        if self.state is None:
            raise RuntimeError("call update() first")
        lw = np.asarray(self.state.log_w, np.float64)
        w = np.exp(lw - lw.max())
        w /= w.sum()
        rng = np.random.default_rng(seed)
        n = self.n if n_draws is None else int(n_draws)
        idx = rng.choice(self.n, size=n, p=w)
        return np.asarray(self.state.particles)[idx]

    def moments(self):
        """Weighted posterior mean and covariance of the current cloud."""
        if self.state is None:
            raise RuntimeError("call update() first")
        x = np.asarray(self.state.particles, np.float64)
        lw = np.asarray(self.state.log_w, np.float64)
        w = np.exp(lw - lw.max())
        w /= w.sum()
        mean = w @ x
        centered = x - mean
        cov = (centered * w[:, None]).T @ centered / (1.0 - (w ** 2).sum())
        return mean, cov
