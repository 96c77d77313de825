"""Nested sampling: evidence + posterior from a batched live-point set.

Beyond-reference capability (the reference — jmatta1/MCMCpp — has no
evidence machinery at all; SURVEY.md §2 covers samplers + diagnostics
only). Completes the evidence triad next to ``SMCSampler.log_evidence``
and ``ParallelTemperingSampler.log_evidence`` (power posteriors): nested
sampling is the only one of the three that also yields the full
sequence of likelihood-shell volumes, so it handles multimodal and
phase-transition posteriors the annealed ladders miss.

Accelerator-first design, not a port of any CPU nested sampler:

- the live set is ONE ``(N, P)`` device array; each outer iteration
  removes the ``B`` worst points in a single sort and regenerates all
  ``B`` replacements as one batched constrained random walk (affine-
  invariant stretch proposals against the surviving live set — scale-
  free, no tuning, the same g(z) machinery as the ensemble sampler),
  ``M`` steps unrolled in a ``fori_loop`` inside one jitted program.
- batched removal uses the varying-live-count shrinkage accounting of
  dynamic nested sampling (Higson et al. 2019): removing the rank-j
  worst of n_j = N-j+1 live points shrinks log X by E[log t] = -1/n_j,
  so one batch of B deaths advances log X by -Σ_{j=0}^{B-1} 1/(N-j).
- evidence/weight accumulation runs on host in float64 (the device is
  busy with likelihoods; the scalar ledger costs nothing and avoids
  float32 drift over thousands of shells).

Hard likelihood constraints (log L = -inf regions) are supported: dead
zones just rank worst and are never swapped back in.
"""

import math
from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp


class NestedResult(NamedTuple):
    logz: float  # log evidence
    logz_err: float  # sqrt(H / N) information-based uncertainty
    h: float  # information (nats)
    n_iters: int  # outer batches executed
    n_calls: int  # total likelihood evaluations
    samples: np.ndarray  # (D, P) dead points, worst-first
    logl: np.ndarray  # (D,) their log-likelihoods
    logw: np.ndarray  # (D,) normalized posterior log-weights (sum exp = 1)
    ess: float  # Kish effective sample size of the weights


def _shrink(n_live, batch):
    """-Σ 1/(N-j) for j=0..B-1 and the per-death partial sums."""
    counts = n_live - np.arange(batch)
    steps = 1.0 / counts
    return np.cumsum(steps)


class NestedSampler:
    """Static-live-set nested sampling with batched deaths.

    logprior_fn: (P,) -> scalar log prior density (JAX-traceable).
    loglike_fn: (P,) -> scalar log likelihood (-inf allowed).
    prior_sample: (key, n) -> (n, P) exact prior draws (seeds the live set).
    n_live: live-set size N (evidence error ~ sqrt(H/N)).
    batch: deaths per iteration B (default N//4; smaller = finer shells,
        larger = better device utilization).
    n_mcmc: constrained steps per replacement (decorrelation length;
        20-40 stretch steps or 3-8 slice directions are the usual ranges).
    kernel: ``"stretch"`` (default; affine-invariant walk against the
        survivors — cheap per step) or ``"slice"`` (PolyChord-style
        random-direction slice sampling in live-set-whitened coordinates
        — rejection-free along each direction, more robust in higher
        dimensions where stretch acceptance collapses).
    a: stretch scale (g(z) support [1/a, a], cf. ops/gw.py).
    mesh: optional ``jax.sharding.Mesh`` — shards the ``(N, P)`` live set
        and the ``(B, P)`` regrowth walkers over the mesh. Cross-device
        design decision for the B-worst selection: the rank sort runs as
        XLA's GLOBAL sort over the sharded live axis, which GSPMD lowers
        to an all-gather + local sort. That is deliberate — live sets are
        small (≤ a few thousand (P+2)-float rows, tens of KB to gather)
        while the dominant cost, the B regrowth chains' ``n_mcmc``
        likelihood sweeps, partitions over the mesh with no communication.
        A distributed multi-device sort would save a tiny gather and
        complicate the shrinkage accounting for nothing.
    """

    def __init__(self, logprior_fn, loglike_fn, prior_sample, n_params,
                 n_live=500, batch=None, n_mcmc=30, a=2.0, seed=0,
                 dtype=jnp.float32, kernel="stretch", max_slice_expand=8,
                 max_slice_shrink=32, mesh=None):
        if kernel not in ("stretch", "slice"):
            raise ValueError(f"unknown kernel {kernel!r}")
        self.kernel = kernel
        self.max_slice_expand = int(max_slice_expand)
        self.max_slice_shrink = int(max_slice_shrink)
        self.n_params = int(n_params)
        self.n_live = int(n_live)
        self.batch = int(batch) if batch is not None else max(
            1, self.n_live // 4
        )
        if not 0 < self.batch < self.n_live:
            raise ValueError(
                f"batch={self.batch} must be in (0, n_live={self.n_live})"
            )
        self.n_mcmc = int(n_mcmc)
        self.a = float(a)
        self.dtype = dtype
        self._prior_sample = prior_sample
        self._logprior = jax.vmap(logprior_fn)
        self._loglike = jax.vmap(loglike_fn)
        self._key = jax.random.key(seed)
        self.mesh = mesh
        self._row_sharding = self._vec_sharding = None
        if mesh is not None:
            from mcmcpp_tpu.parallel.mesh import (
                vector_sharding,
                walker_sharding,
            )

            self._row_sharding = walker_sharding(mesh)
            self._vec_sharding = vector_sharding(self._row_sharding)
        self._iterate = jax.jit(self._build_iterate())
        self.result = None
        # resumable run state (checkpoint/resume: io/checkpoint.py
        # kind="nested"); None until run() initializes the live set
        self._live = self._ll = self._lpp = None
        self._dead_pos = []
        self._dead_ll = []
        self._dead_logw = []
        self._logz = -np.inf
        self._logx = 0.0
        self._n_calls = 0
        self._iters_done = 0
        self._low_acc_warned = False

    def reset(self):
        """Discard mid-run state so the next :meth:`run` starts fresh."""
        self._live = self._ll = self._lpp = None
        self._dead_pos, self._dead_ll, self._dead_logw = [], [], []
        self._logz, self._logx = -np.inf, 0.0
        self._n_calls = 0
        self._iters_done = 0
        self._low_acc_warned = False
        self.result = None
        return self

    def _constrain_rows(self, pos, *vecs):
        """Pin (n, P) rows + (n,) stats to the live-set sharding."""
        if self._row_sharding is None:
            return (pos,) + vecs
        pos = jax.lax.with_sharding_constraint(pos, self._row_sharding)
        vecs = tuple(
            jax.lax.with_sharding_constraint(v, self._vec_sharding)
            for v in vecs
        )
        return (pos,) + vecs

    # -- device kernels ------------------------------------------------------

    def _build_iterate(self):
        n, b, m = self.n_live, self.batch, self.n_mcmc
        a = self.a

        def iterate(key, live, ll, lpp):
            """One batch: sort, kill B worst, regrow B chains above L*.

            Returns (new_live, new_ll, new_lpp, dead, dead_ll, n_accept).
            """
            live, ll, lpp = self._constrain_rows(live, ll, lpp)
            # global rank sort over the (possibly sharded) live axis — see
            # the class docstring for the cross-device design decision
            order = jnp.argsort(ll)  # ascending: worst first
            live, ll, lpp = live[order], ll[order], lpp[order]
            dead, dead_ll = live[:b], ll[:b]
            surv, surv_ll, surv_lpp = live[b:], ll[b:], lpp[b:]
            lstar = ll[b - 1]  # highest killed likelihood
            k_seed, k_walk = jax.random.split(key)
            seed_idx = jax.random.randint(k_seed, (b,), 0, n - b)
            pos = surv[seed_idx]
            pos_ll = surv_ll[seed_idx]
            pos_lpp = surv_lpp[seed_idx]
            # the regrowth walkers carry the dominant cost (n_mcmc
            # likelihood sweeps) — shard them over the mesh
            pos, pos_ll, pos_lpp = self._constrain_rows(pos, pos_ll, pos_lpp)

            def step(i, carry):
                pos, pos_ll, pos_lpp, acc = carry
                kk = jax.random.fold_in(k_walk, i)
                kz, kp, ku = jax.random.split(kk, 3)
                # affine-invariant stretch against the survivors:
                # y = c + z (x - c), z ~ g(z) on [1/a, a]
                # (MCMCpp/Movers/StretchMove.h:110 semantics, constrained)
                u = jax.random.uniform(kz, (b,), pos.dtype)
                z = (u * (a - 1.0) + 1.0) ** 2 / a
                c_idx = jax.random.randint(kp, (b,), 0, n - b)
                c = surv[c_idx]
                prop = c + z[:, None] * (pos - c)
                prop_lpp = self._logprior(prop)
                prop_ll = self._loglike(prop)
                # target: prior restricted to {L > L*}
                log_ratio = (
                    (self.n_params - 1) * jnp.log(z)
                    + prop_lpp - pos_lpp
                )
                log_u = -jax.random.exponential(ku, (b,), pos.dtype)
                ok = (log_u < log_ratio) & (prop_ll > lstar)
                pos = jnp.where(ok[:, None], prop, pos)
                pos_ll = jnp.where(ok, prop_ll, pos_ll)
                pos_lpp = jnp.where(ok, prop_lpp, pos_lpp)
                return pos, pos_ll, pos_lpp, acc + jnp.sum(ok)

            if self.kernel == "slice":
                # live-set-whitened random-direction slice sampling
                # (PolyChord, Handley et al. 2015): rejection-free along
                # each direction, so "acc" counts directions completed
                cov = jnp.cov(surv, rowvar=False).reshape(
                    self.n_params, self.n_params
                )
                chol = jnp.linalg.cholesky(
                    cov + 1e-8 * jnp.eye(self.n_params, dtype=pos.dtype)
                )

                def slice_one(key, x, x_ll, x_lpp):
                    def direction_step(i, c):
                        x, x_ll, x_lpp, key, evals = c
                        key, kd, kh, kb, kj, ks = jax.random.split(key, 6)
                        z = jax.random.normal(kd, (self.n_params,), x.dtype)
                        d = chol @ (z / jnp.linalg.norm(z))
                        # slice height under the constrained prior
                        log_y = x_lpp - jax.random.exponential(
                            kh, (), x.dtype
                        )

                        def g(t):
                            p = x + t * d
                            return (jnp.where(
                                self._loglike(p[None, :])[0] > lstar,
                                self._logprior(p[None, :])[0],
                                -jnp.inf,
                            ), p)

                        # fixed-width stepping-out (Neal 2003, Fig. 3):
                        # unit whitened width, randomly placed, each end
                        # extended by one width while inside the slice.
                        # Doubling without Neal's acceptance back-test
                        # (the round-2 version) does not leave the
                        # constrained prior exactly invariant; fixed-width
                        # stepping-out needs no back-test. The expansion
                        # cap is split randomly between the two ends
                        # (J ~ Unif{0..m}, Neal's scheme) so even a
                        # binding cap preserves reversibility.
                        u0 = jax.random.uniform(kb, (), x.dtype)
                        lo0, hi0 = -u0, 1.0 - u0
                        m_cap = jnp.int32(self.max_slice_expand)
                        j_lo = jax.random.randint(kj, (), 0, m_cap + 1)
                        j_hi = m_cap - j_lo

                        def expand(t0, delta, cap):
                            def cond(c):
                                i, t, open_ = c
                                return open_ & (i < cap)

                            def body(c):
                                i, t, _ = c
                                t2 = t + delta
                                val, _ = g(t2)
                                return (i + 1, t2, val > log_y)

                            val0, _ = g(t0)
                            i, t, _ = jax.lax.while_loop(
                                cond, body, (jnp.int32(0), t0, val0 > log_y)
                            )
                            return t, i + 1  # +1: the t0 evaluation

                        one = jnp.asarray(1.0, x.dtype)
                        lo, e_lo = expand(lo0, -one, j_lo)
                        hi, e_hi = expand(hi0, one, j_hi)

                        def shrink_cond(c):
                            i, lo, hi, t, val, p, key = c
                            return (val <= log_y) & (
                                i < self.max_slice_shrink
                            )

                        def shrink_body(c):
                            i, lo, hi, t, val, p, key = c
                            key, ku = jax.random.split(key)
                            t2 = lo + jax.random.uniform(
                                ku, (), x.dtype
                            ) * (hi - lo)
                            val2, p2 = g(t2)
                            lo = jnp.where((val2 <= log_y) & (t2 < 0), t2, lo)
                            hi = jnp.where(
                                (val2 <= log_y) & (t2 >= 0), t2, hi
                            )
                            return (i + 1, lo, hi, t2, val2, p2, key)

                        i0 = (jnp.int32(0), lo, hi, jnp.zeros((), x.dtype),
                              -jnp.inf, x, ks)
                        i_sh, _, _, t, val, p, _ = jax.lax.while_loop(
                            shrink_cond, shrink_body, i0
                        )
                        ok = val > log_y  # shrink cap hit -> keep x
                        new_x = jnp.where(ok, p, x)
                        new_ll = jnp.where(
                            ok, self._loglike(new_x[None, :])[0], x_ll
                        )
                        new_lpp = jnp.where(
                            ok, self._logprior(new_x[None, :])[0], x_lpp
                        )
                        evals = evals + e_lo + e_hi + i_sh + 1
                        return (new_x, new_ll, new_lpp, key, evals)

                    x, x_ll, x_lpp, _, evals = jax.lax.fori_loop(
                        0, m, direction_step,
                        (x, x_ll, x_lpp, key, jnp.int32(0)),
                    )
                    return x, x_ll, x_lpp, evals

                keys = jax.random.split(k_walk, b)
                pos, pos_ll, pos_lpp, evals = jax.vmap(slice_one)(
                    keys, pos, pos_ll, pos_lpp
                )
                # acc carries the TOTAL likelihood evaluations (the slice
                # kernel is rejection-free; run() branches on self.kernel)
                acc = jnp.sum(evals)
            else:
                pos, pos_ll, pos_lpp, acc = jax.lax.fori_loop(
                    0, m, step,
                    (pos, pos_ll, pos_lpp, jnp.zeros((), jnp.int32)),
                )
            new_live = jnp.concatenate([surv, pos], 0)
            new_ll = jnp.concatenate([surv_ll, pos_ll], 0)
            new_lpp = jnp.concatenate([surv_lpp, pos_lpp], 0)
            new_live, new_ll, new_lpp = self._constrain_rows(
                new_live, new_ll, new_lpp
            )
            return new_live, new_ll, new_lpp, dead, dead_ll, acc

        return iterate

    # -- host ledger ---------------------------------------------------------

    def run(self, dlogz=0.01, max_iters=100_000, min_accept=0.05):
        """Iterate until the live set's remaining evidence contribution
        drops below ``dlogz`` nats. Returns (and stores) a NestedResult.

        ``min_accept``: warn if constrained-walk acceptance falls below
        this (replacements then correlate with their seeds; raise n_mcmc
        or n_live).

        Resumable: a second ``run()`` call CONTINUES from the current
        live set and dead-point ledger (``max_iters`` bounds the
        additional iterations of that call), bitwise-identically to an
        uninterrupted run — so a budget-capped run, a loaded checkpoint
        (``io.checkpoint`` kind="nested"), or a run interrupted mid-way
        loses nothing. Call :meth:`reset` to start over.
        """
        n, b = self.n_live, self.batch
        if self._live is None:
            self._key, k_init = jax.random.split(self._key)
            live = jnp.asarray(self._prior_sample(k_init, n), self.dtype)
            if live.shape != (n, self.n_params):
                raise ValueError(
                    f"prior_sample returned {live.shape}, expected "
                    f"{(n, self.n_params)}"
                )
            if self._row_sharding is not None:
                live = jax.device_put(live, self._row_sharding)
            self._live = live
            self._ll = self._loglike(live)
            self._lpp = self._logprior(live)
            self._n_calls = n

        live, ll, lpp = self._live, self._ll, self._lpp
        logx_steps = _shrink(n, b)  # cumulative shrink per death in a batch
        logz = self._logz
        logx = self._logx  # current log prior volume
        for _ in range(int(max_iters)):
            self._key, k_it = jax.random.split(self._key)
            live, ll, lpp, dead, d_ll, acc = self._iterate(
                k_it, live, ll, lpp
            )
            self._iters_done += 1
            self._n_calls += (int(acc) if self.kernel == "slice"
                              else b * self.n_mcmc)
            d_ll = np.asarray(d_ll, np.float64)
            self._dead_pos.append(np.asarray(dead))
            self._dead_ll.append(d_ll)
            # shell weights in LOG space: log(X_{j-1} − X_j) =
            # log X_{j-1} + log(−expm1(Δlog X)); linear-space subtraction
            # underflows once log X < ~−745 (high-information runs) and
            # would silently clamp every deep shell to the same width
            logx_new = logx - logx_steps  # (B,) volumes after each death
            logx_prev = np.concatenate([[logx], logx_new[:-1]])
            log_width = logx_prev + np.log(-np.expm1(logx_new - logx_prev))
            logw = log_width + d_ll
            self._dead_logw.append(logw)
            logz = np.logaddexp(logz, _logsumexp(logw))
            logx = float(logx_new[-1])
            self._logz, self._logx = logz, logx
            acc_rate = (1.0 if self.kernel == "slice"
                        else float(acc) / (b * self.n_mcmc))
            if acc_rate < min_accept and not self._low_acc_warned:
                import warnings

                warnings.warn(
                    f"constrained-walk acceptance {acc_rate:.3f} < "
                    f"{min_accept} at iteration {self._iters_done}; "
                    "replacements may correlate with seeds (raise n_mcmc "
                    "or n_live)",
                    stacklevel=2,
                )
                self._low_acc_warned = True
            # termination: best-case remaining evidence in the live set
            ll_max = float(jnp.max(ll))
            remain = logx + ll_max
            if np.isfinite(logz) and (
                np.logaddexp(logz, remain) - logz < dlogz
            ):
                break
        self._live, self._ll, self._lpp = live, ll, lpp

        # final increment: surviving live points share the last volume.
        # Finalization reads COPIES, so a continued run can re-finalize.
        live_np = np.asarray(live)
        ll_np = np.asarray(ll, np.float64)
        with np.errstate(divide="ignore", invalid="ignore"):
            logw_live = (logx - np.log(n)) + ll_np
        logz = np.logaddexp(logz, _logsumexp(logw_live))

        samples = np.concatenate(self._dead_pos + [live_np], 0)
        logl = np.concatenate(self._dead_ll + [ll_np], 0)
        logw = np.concatenate(self._dead_logw + [logw_live]) - logz
        # information H = Σ p_j ln L_j − ln Z (Skilling 2006, eq. 17)
        finite = np.isfinite(logw) & np.isfinite(logl)
        h = float(np.sum(np.exp(logw[finite]) * logl[finite]) - logz)
        wsum = np.exp(_logsumexp(2.0 * logw))
        ess = 1.0 / wsum if wsum > 0 else 0.0
        self.result = NestedResult(
            logz=float(logz),
            logz_err=float(math.sqrt(max(h, 0.0) / n)),
            h=float(h),
            n_iters=self._iters_done,
            n_calls=int(self._n_calls),
            samples=samples,
            logl=logl,
            logw=logw,
            ess=float(ess),
        )
        return self.result

    @property
    def log_evidence(self):
        if self.result is None:
            raise RuntimeError("call run() first")
        return self.result.logz

    def posterior_samples(self, n_draws=1000, seed=0):
        """Equal-weight posterior draws by categorical resampling of the
        dead points (the standard nested-sampling posterior readout)."""
        if self.result is None:
            raise RuntimeError("call run() first")
        rng = np.random.default_rng(seed)
        w = np.exp(self.result.logw - self.result.logw.max())
        w /= w.sum()
        idx = rng.choice(w.size, size=int(n_draws), p=w)
        return self.result.samples[idx]


def _logsumexp(x):
    x = np.asarray(x, np.float64)
    m = np.max(x) if x.size else -np.inf
    if not np.isfinite(m):
        return m
    return m + np.log(np.sum(np.exp(x - m)))


