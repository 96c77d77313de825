"""Parallel tempering (replica exchange) over a temperature × walker grid.

Beyond-reference capability (ROADMAP item, natural accelerator fit): K tempered
replicas of the full red/black walker ensemble run as ONE ``(K, W/2, P)``
batch — the temperature axis is just another vmapped (and shardable)
dimension. Each replica targets π^β_k with a shared mover (acceptance
tempered via ``Mover.update_half(beta=...)``, log-probs stored RAW); every
``swap_every`` steps adjacent-temperature replicas propose per-walker state
swaps with the standard exchange rule

    log α = (β_k − β_{k+1}) · (logp_{k+1} − logp_k)

in alternating even/odd pair phases (the red/black idea applied to the
ladder). Samples are read from the β = 1 replica.
"""

from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from mcmcpp_tpu.chain import Chain, append_device_chunk, default_chunk_steps
from mcmcpp_tpu.movers.stretch import StretchMove


class PTState(NamedTuple):
    red: jax.Array  # (K, H, P)
    black: jax.Array  # (K, H, P)
    logp_red: jax.Array  # (K, H) raw logp (power mode: log-PRIOR)
    logp_black: jax.Array  # (K, H)
    step: jax.Array
    swaps_accepted: jax.Array  # (K-1,) int32
    swaps_proposed: jax.Array  # (K-1,) int32
    # power-posterior (evidence) mode only; None otherwise
    ll_red: jax.Array = None  # (K, H) log-likelihood
    ll_black: jax.Array = None  # (K, H)
    ll_mean: jax.Array = None  # (K,) running mean of per-step walker-mean ll
    ll_m2: jax.Array = None  # (K,) running sum of squared deviations
    ss_max: jax.Array = None  # (K-1,) streaming logsumexp max of dβ·ll
    ss_sum: jax.Array = None  # (K-1,) streaming logsumexp scaled sum
    acc_n: jax.Array = None  # () float32 number of accumulated steps
    ll_n: jax.Array = None  # (K,) steps with a FINITE walker-mean log L


def geometric_ladder(n_temps, beta_min=0.01):
    """β ladder 1 → beta_min, geometric spacing (standard default)."""
    return jnp.asarray(
        np.geomspace(1.0, beta_min, n_temps), jnp.float32
    )


def power_ladder(n_temps, exponent=5.0):
    """β ladder 1 → 0 with β_k = ((K-1-k)/(K-1))^c, the Friel & Pettitt
    (2008) power-posterior schedule (c≈5 concentrates rungs near the prior
    where E_β[log L] changes fastest). Use for evidence runs — the ladder
    must reach β=0 (the prior) for thermodynamic integration."""
    k = np.arange(n_temps, dtype=np.float64)
    return jnp.asarray(
        ((n_temps - 1 - k) / (n_temps - 1)) ** exponent, jnp.float32
    )


def _neighbor_diff(score):
    """score[k+1] - score[k] per adjacent ladder pair, -inf-safe (a pair of
    zero-likelihood walkers has exchange ratio 1, not NaN)."""
    hi, lo = score[1:], score[:-1]
    both_inf = jnp.isneginf(hi) & jnp.isneginf(lo)
    return jnp.where(both_inf, 0.0, hi - lo)


def _swap_phase(key, pos_r, pos_b, lp_r, lp_b, betas, parity,
                score_r=None, score_b=None, extra_r=(), extra_b=()):
    """Propose swaps between ladder pairs (k, k+1) with k ≡ parity (mod 2).

    Swaps act on the FULL replica state (both halves) per walker. The
    exchange decision uses ``score`` (defaults to ``lp``; power-posterior
    mode passes the log-likelihood grids); ``extra_*`` are further (K, H)
    grids co-swapped with the same per-walker masks.
    """
    k_dim = pos_r.shape[0]
    dbeta = betas[:-1] - betas[1:]  # (K-1,)
    score_r = lp_r if score_r is None else score_r
    score_b = lp_b if score_b is None else score_b
    # per-walker exchange decisions for every adjacent pair; only pairs of
    # the current parity act, so active pairs touch disjoint replica rows
    log_alpha_r = dbeta[:, None] * _neighbor_diff(score_r)  # (K-1, H)
    log_alpha_b = dbeta[:, None] * _neighbor_diff(score_b)
    kr, kb = jax.random.split(key)
    u_r = -jax.random.exponential(kr, log_alpha_r.shape, log_alpha_r.dtype)
    u_b = -jax.random.exponential(kb, log_alpha_b.shape, log_alpha_b.dtype)
    pair_idx = jnp.arange(k_dim - 1)
    active_pair = (pair_idx % 2) == parity  # (K-1,)
    acc_r = (u_r < log_alpha_r) & active_pair[:, None]  # (K-1, H)
    acc_b = (u_b < log_alpha_b) & active_pair[:, None]

    def apply(pos, acc):
        # build swapped copies: row k takes from k+1 where acc[k], and
        # row k+1 takes from k where acc[k]
        take_upper = jnp.zeros(pos.shape[:2], bool)  # row k <- k+1
        take_upper = take_upper.at[:-1].set(acc)
        take_lower = jnp.zeros(pos.shape[:2], bool)  # row k+1 <- k
        take_lower = take_lower.at[1:].set(acc)
        if pos.ndim == 3:
            take_upper = take_upper[..., None]
            take_lower = take_lower[..., None]
        up = jnp.roll(pos, -1, axis=0)  # row k holds pos[k+1]
        down = jnp.roll(pos, 1, axis=0)
        new_pos = jnp.where(take_upper, up, pos)
        return jnp.where(take_lower, down, new_pos)

    pos_r, lp_r = apply(pos_r, acc_r), apply(lp_r, acc_r)
    pos_b, lp_b = apply(pos_b, acc_b), apply(lp_b, acc_b)
    extra_r = tuple(apply(g, acc_r) for g in extra_r)
    extra_b = tuple(apply(g, acc_b) for g in extra_b)
    n_acc = jnp.sum(acc_r, axis=1) + jnp.sum(acc_b, axis=1)  # (K-1,)
    h = pos_r.shape[1]
    n_prop = active_pair.astype(jnp.int32) * (2 * h)
    return (pos_r, pos_b, lp_r, lp_b, n_acc.astype(jnp.int32), n_prop,
            extra_r, extra_b)


class ParallelTemperingSampler:
    """Replica-exchange ensemble sampler.

    logp_fn: (P,) -> scalar raw log-posterior (JAX-traceable).
    n_temps/betas: ladder size or explicit β vector (β[0] must be 1).
    swap_every: steps between exchange phases.
    Samples/statistics are exposed for the cold (β=1) replica; swap
    acceptance rates per ladder pair via ``swap_acceptance``.

    **Power-posterior (evidence) mode**: pass ``loglike_fn`` and
    ``logprior_fn`` INSTEAD of ``logp_fn``. Replica k then targets
    prior(x) · L(x)^β_k (the prior is never tempered), the β=0 rung is the
    prior itself, and per-replica log-likelihood statistics are accumulated
    on device so ``log_evidence()`` can return the stepping-stone (Xie et
    al. 2011) or thermodynamic-integration (Friel & Pettitt 2008) estimate
    of log Z = log ∫ prior·L. Use ``power_ladder`` (reaches β=0). The
    reference has no evidence machinery at all (SURVEY.md §2); this mirrors
    ``SMCSampler.log_evidence`` for the replica-exchange engine.
    """

    def __init__(self, logp_fn=None, n_walkers=None, n_params=None,
                 n_temps=8, betas=None, mover=None, seed=0,
                 dtype=jnp.float32, swap_every=1, max_chain_bytes=2 << 30,
                 batched=False, mesh=None, chain=None, loglike_fn=None,
                 logprior_fn=None):
        if n_walkers is None or n_params is None:
            raise TypeError("n_walkers and n_params are required")
        if n_walkers % 2:
            raise ValueError("n_walkers must be even")
        self.n_walkers = int(n_walkers)
        self.n_params = int(n_params)
        self.dtype = dtype
        self.swap_every = int(swap_every)
        self._power = loglike_fn is not None or logprior_fn is not None
        if self._power:
            if loglike_fn is None or logprior_fn is None:
                raise ValueError(
                    "power-posterior mode needs BOTH loglike_fn and "
                    "logprior_fn"
                )
            if logp_fn is not None:
                raise ValueError(
                    "pass either logp_fn OR (loglike_fn, logprior_fn)"
                )
        elif logp_fn is None:
            raise TypeError("logp_fn is required (or loglike_fn+logprior_fn)")
        self.betas = (jnp.asarray(betas, dtype) if betas is not None
                      else (power_ladder(n_temps) if self._power
                            else geometric_ladder(n_temps)))
        if float(self.betas[0]) != 1.0:
            raise ValueError("betas[0] must be 1.0 (the cold chain)")
        if not self._power and float(self.betas[-1]) <= 0.0:
            raise ValueError(
                "β=0 tempers the whole posterior to an improper flat "
                "target; β=0 rungs need power-posterior mode "
                "(loglike_fn+logprior_fn)"
            )
        self.n_temps = int(self.betas.shape[0])
        self.mover = mover if mover is not None else StretchMove()
        from mcmcpp_tpu.movers.base import Mover

        if self._power and (
            type(self.mover).propose is Mover.propose
            or self.mover.always_accept
        ):
            raise ValueError(
                "power-posterior mode needs a propose-based Metropolis "
                f"mover (got {type(self.mover).__name__})"
            )
        self._mover_state = self.mover.init_state(self.n_params, dtype)
        if self._power:
            self._batched_ll = (loglike_fn if batched
                                else jax.vmap(loglike_fn))
            self._batched_prior = (logprior_fn if batched
                                   else jax.vmap(logprior_fn))
            self._batched_logp = lambda x: (
                self._batched_prior(x) + self._batched_ll(x)
            )
        else:
            self._batched_logp = logp_fn if batched else jax.vmap(logp_fn)
        self._key = jax.random.key(seed)
        self._step_key, self._aux_key = jax.random.split(self._key)
        self._step_epoch = 0
        self._epoch_key = jax.random.fold_in(self._step_key, 0)
        self.state = None
        if chain is not None:
            if (chain.n_walkers, chain.n_params) != (
                self.n_walkers, self.n_params,
            ):
                raise ValueError("injected chain store geometry mismatch")
            self.chain = chain
        else:
            self.chain = Chain(
                n_walkers=self.n_walkers, n_params=self.n_params,
                max_bytes=max_chain_bytes,
                dtype=np.dtype(jax.dtypes.canonicalize_dtype(dtype)),
            )
        self._run_cache = {}
        self._swaps_acc_host = np.zeros(self.n_temps - 1, np.int64)
        self._swaps_prop_host = np.zeros(self.n_temps - 1, np.int64)
        # optional mesh sharding, two layouts picked by the mesh axis names:
        # - walker mesh (parallel/mesh.make_walker_mesh): the (K, H, P) grid
        #   shards its WALKER axis over the whole mesh (ladder replicated) —
        #   exchange phases are per-walker elementwise, so swaps need no
        #   collectives; only the mover's partner roll crosses devices.
        # - ladder mesh (parallel/mesh.make_ladder_mesh, for K > device
        #   count): K shards over the "ladder" axis, H over "walkers"; the
        #   K-axis rolls in the swap phase become neighbor
        #   collective-permutes over the ladder axis.
        self.mesh = mesh
        self._grid_sh = self._gridvec_sh = self._rep_sh = None
        if mesh is not None:
            from mcmcpp_tpu.parallel.mesh import (
                grid_sharding,
                ladder_grid_sharding,
                replicated,
            )

            if "ladder" in mesh.axis_names:
                kd = mesh.shape["ladder"]
                wd = mesh.shape["walkers"]
                if self.n_temps % kd != 0:
                    raise ValueError(
                        f"ladder size {self.n_temps} not divisible by the "
                        f"mesh's {kd} ladder shards"
                    )
                if (self.n_walkers // 2) % wd != 0:
                    raise ValueError(
                        f"half-ensemble size {self.n_walkers // 2} not "
                        f"divisible by {wd} walker shards"
                    )
                self._grid_sh = ladder_grid_sharding(mesh, ndim=3)
                self._gridvec_sh = ladder_grid_sharding(mesh, ndim=2)
            else:
                if (self.n_walkers // 2) % mesh.size != 0:
                    raise ValueError(
                        f"half-ensemble size {self.n_walkers // 2} not "
                        f"divisible by mesh size {mesh.size}"
                    )
                self._grid_sh = grid_sharding(mesh, ndim=3)
                self._gridvec_sh = grid_sharding(mesh, ndim=2)
            self._rep_sh = replicated(mesh)

    def init_ball(self, center, scale=1e-2, seed=None):
        key = self._aux_key if seed is None else jax.random.key(seed)
        center = jnp.asarray(center, self.dtype)
        z = jax.random.normal(
            key, (self.n_temps, self.n_walkers, self.n_params), self.dtype
        )
        pos = center[None, None, :] + scale * z
        h = self.n_walkers // 2
        red, black = pos[:, :h], pos[:, h:]
        if self._grid_sh is not None:
            red = jax.device_put(red, self._grid_sh)
            black = jax.device_put(black, self._grid_sh)
        extra = {}
        if self._power:
            prior = lambda x: jax.vmap(self._batched_prior)(x)
            ll = lambda x: jax.vmap(self._batched_ll)(x)
            # logp grids hold the PRIOR in power mode (ll kept separately,
            # so -inf likelihoods never poison the prior via subtraction)
            lp_red, lp_black = prior(red), prior(black)
            extra = dict(
                ll_red=ll(red), ll_black=ll(black),
                **self._zero_evidence_acc(),
            )
        else:
            f = lambda x: jax.vmap(self._batched_logp)(x)
            lp_red, lp_black = f(red), f(black)
        self.state = PTState(
            red=red, black=black,
            logp_red=lp_red, logp_black=lp_black,
            step=jnp.zeros((), jnp.int32),
            swaps_accepted=jnp.zeros((self.n_temps - 1,), jnp.int32),
            swaps_proposed=jnp.zeros((self.n_temps - 1,), jnp.int32),
            **extra,
        )
        return self

    def _zero_evidence_acc(self):
        k = self.n_temps
        return dict(
            ll_mean=jnp.zeros((k,), self.dtype),
            ll_m2=jnp.zeros((k,), self.dtype),
            ss_max=jnp.full((k - 1,), -jnp.inf, self.dtype),
            ss_sum=jnp.zeros((k - 1,), self.dtype),
            acc_n=jnp.zeros((), self.dtype),
            ll_n=jnp.zeros((k,), self.dtype),
        )

    def _constrain(self, state: PTState) -> PTState:
        if self._grid_sh is None:
            return state
        c = lambda x: jax.lax.with_sharding_constraint(x, self._grid_sh)
        v = lambda x: jax.lax.with_sharding_constraint(x, self._gridvec_sh)
        r = lambda x: jax.lax.with_sharding_constraint(x, self._rep_sh)
        extra = {}
        if self._power:
            extra = dict(
                ll_red=v(state.ll_red), ll_black=v(state.ll_black),
                # evidence accumulators are global statistics, like the
                # swap counters: replicated so every host can read them
                ll_mean=r(state.ll_mean), ll_m2=r(state.ll_m2),
                ss_max=r(state.ss_max), ss_sum=r(state.ss_sum),
                acc_n=r(state.acc_n), ll_n=r(state.ll_n),
            )
        return state._replace(
            red=c(state.red), black=c(state.black),
            logp_red=v(state.logp_red), logp_black=v(state.logp_black),
            # swap counters are global statistics: pin them replicated so
            # every host can read them directly (multi-host safe)
            swaps_accepted=r(state.swaps_accepted),
            swaps_proposed=r(state.swaps_proposed),
            **extra,
        )

    def _step(self, state: PTState) -> PTState:
        if self._power:
            return self._step_power(state)
        state = self._constrain(state)
        key = jax.random.fold_in(self._epoch_key, state.step)
        k_red, k_black, k_swap = jax.random.split(key, 3)

        def half_update(key, active, lp, other, beta):
            return self.mover.update_half(
                key, active, lp, other, self._batched_logp,
                self._mover_state, beta=beta,
            )

        keys_r = jax.random.split(k_red, self.n_temps)
        red, lp_red, _ = jax.vmap(half_update)(
            keys_r, state.red, state.logp_red, state.black, self.betas
        )
        keys_b = jax.random.split(k_black, self.n_temps)
        black, lp_black, _ = jax.vmap(half_update)(
            keys_b, state.black, state.logp_black, red, self.betas
        )
        swaps_acc, swaps_prop = state.swaps_accepted, state.swaps_proposed

        def do_swap(args):
            red, black, lp_red, lp_black, sa, sp = args
            parity = (state.step // self.swap_every) % 2
            r, b, lr, lb, n_acc, n_prop, _, _ = _swap_phase(
                k_swap, red, black, lp_red, lp_black, self.betas, parity
            )
            return r, b, lr, lb, sa + n_acc, sp + n_prop

        red, black, lp_red, lp_black, swaps_acc, swaps_prop = jax.lax.cond(
            (state.step + 1) % self.swap_every == 0,
            do_swap,
            lambda args: args,
            (red, black, lp_red, lp_black, swaps_acc, swaps_prop),
        )
        return PTState(red, black, lp_red, lp_black, state.step + 1,
                       swaps_acc, swaps_prop)

    def _step_power(self, state: PTState) -> PTState:
        """One power-posterior step: per-replica Metropolis against
        prior·L^β (prior never tempered), ladder swaps scored on the
        log-likelihood, then on-device evidence accumulation."""
        state = self._constrain(state)
        key = jax.random.fold_in(self._epoch_key, state.step)
        k_red, k_black, k_swap = jax.random.split(key, 3)

        def half_update(key, active, prior, ll, other, beta):
            kp, ka = jax.random.split(key)
            proposal, log_factor = self.mover.propose(
                kp, active, other, self._mover_state
            )
            prop_ll = self._batched_ll(proposal)
            prop_prior = self._batched_prior(proposal)
            # β·Δll with both lls at -inf would be NaN; such a move holds
            # the (zero) likelihood fixed, so its ratio term is 0 — the
            # walker keeps exploring the prior until L > 0
            both = jnp.isneginf(prop_ll) & jnp.isneginf(ll)
            dll = jnp.where(both, 0.0, prop_ll - ll)
            # β=0 (the prior rung) ignores the likelihood ENTIRELY — 0·±inf
            # would be NaN and permanently freeze walkers against the
            # support boundary
            tempered = jnp.where(beta > 0.0, beta * dll, 0.0)
            log_ratio = log_factor + (prop_prior - prior) + tempered
            log_u = -jax.random.exponential(ka, prior.shape, prior.dtype)
            acc = log_u < log_ratio
            new_active = jnp.where(acc[:, None], proposal, active)
            new_prior = jnp.where(acc, prop_prior, prior)
            new_ll = jnp.where(acc, prop_ll, ll)
            return new_active, new_prior, new_ll

        keys_r = jax.random.split(k_red, self.n_temps)
        red, lp_red, ll_red = jax.vmap(half_update)(
            keys_r, state.red, state.logp_red, state.ll_red, state.black,
            self.betas,
        )
        keys_b = jax.random.split(k_black, self.n_temps)
        black, lp_black, ll_black = jax.vmap(half_update)(
            keys_b, state.black, state.logp_black, state.ll_black, red,
            self.betas,
        )
        swaps_acc, swaps_prop = state.swaps_accepted, state.swaps_proposed

        def do_swap(args):
            red, black, lp_red, lp_black, ll_r, ll_b, sa, sp = args
            parity = (state.step // self.swap_every) % 2
            r, b, lr, lb, n_acc, n_prop, ex_r, ex_b = _swap_phase(
                k_swap, red, black, lp_red, lp_black, self.betas, parity,
                score_r=ll_r, score_b=ll_b, extra_r=(ll_r,), extra_b=(ll_b,),
            )
            return r, b, lr, lb, ex_r[0], ex_b[0], sa + n_acc, sp + n_prop

        (red, black, lp_red, lp_black, ll_red, ll_black, swaps_acc,
         swaps_prop) = jax.lax.cond(
            (state.step + 1) % self.swap_every == 0,
            do_swap,
            lambda args: args,
            (red, black, lp_red, lp_black, ll_red, ll_black, swaps_acc,
             swaps_prop),
        )
        # --- evidence accumulators (one observation = this step) ---------
        ll_all = jnp.concatenate([ll_red, ll_black], axis=1)  # (K, W)
        # TI: Welford over per-step walker-means of log L (β descending),
        # per-rung finite-masked — one -inf walker (hard-constraint
        # likelihoods) must not poison the accumulator into NaN forever
        step_mean = jnp.mean(ll_all, axis=1)  # (K,)
        finite = jnp.isfinite(step_mean)
        safe_mean = jnp.where(finite, step_mean, 0.0)
        n_new = state.acc_n + 1.0
        ll_n = state.ll_n + finite.astype(self.dtype)
        denom = jnp.maximum(ll_n, 1.0)
        delta = safe_mean - state.ll_mean
        ll_mean = jnp.where(
            finite, state.ll_mean + delta / denom, state.ll_mean
        )
        ll_m2 = jnp.where(
            finite,
            state.ll_m2 + delta * (safe_mean - ll_mean),
            state.ll_m2,
        )
        # stepping stone: streaming logsumexp of dβ_k·ll over the β_{k+1}
        # (lower) rung's walkers, merged one per-step LSE at a time
        dbeta = self.betas[:-1] - self.betas[1:]  # (K-1,)
        lo = ll_all[1:]  # (K-1, W)
        x = jnp.where(jnp.isneginf(lo), -jnp.inf, dbeta[:, None] * lo)
        step_lse = jax.scipy.special.logsumexp(x, axis=1)  # (K-1,)
        m_new = jnp.maximum(state.ss_max, step_lse)
        safe = jnp.isfinite(m_new)
        ss_sum = jnp.where(
            safe,
            state.ss_sum * jnp.exp(
                jnp.where(safe, state.ss_max - m_new, 0.0)
            ) + jnp.exp(jnp.where(safe, step_lse - m_new, -jnp.inf)),
            0.0,
        )
        return PTState(red, black, lp_red, lp_black, state.step + 1,
                       swaps_acc, swaps_prop, ll_red=ll_red,
                       ll_black=ll_black, ll_mean=ll_mean, ll_m2=ll_m2,
                       ss_max=m_new, ss_sum=ss_sum, acc_n=n_new,
                       ll_n=ll_n)

    def _scan_fn(self, n_store, thin):
        fn = self._run_cache.get((n_store, thin))
        if fn is None:

            def scan_run(state):
                def body(carry, _):
                    carry = jax.lax.fori_loop(
                        0, thin, lambda i, s: self._step(s), carry
                    )
                    pos = jnp.concatenate([carry.red[0], carry.black[0]], 0)
                    if self._power:
                        # logp grids hold the prior; store the raw posterior
                        lp = jnp.concatenate(
                            [carry.logp_red[0] + carry.ll_red[0],
                             carry.logp_black[0] + carry.ll_black[0]], 0
                        )
                    else:
                        lp = jnp.concatenate(
                            [carry.logp_red[0], carry.logp_black[0]], 0
                        )
                    return carry, (pos, lp)

                return jax.lax.scan(body, state, length=n_store)

            fn = jax.jit(scan_run)
            self._run_cache[(n_store, thin)] = fn
        return fn

    def _harvest_swaps(self):
        """Move int32 device swap counters into host ints (overflow-safe)."""
        self._swaps_acc_host += np.asarray(self.state.swaps_accepted, np.int64)
        self._swaps_prop_host += np.asarray(self.state.swaps_proposed, np.int64)
        zero = jnp.zeros((self.n_temps - 1,), jnp.int32)
        self.state = self.state._replace(
            swaps_accepted=zero, swaps_proposed=zero
        )

    def run_mcmc(self, n_steps, thin=1):
        """Advance all replicas; store the cold chain every ``thin`` steps.

        Returns False if the cold chain hit its byte capacity (further
        stores are skipped, ≙ EndOfChain), else True. Leftover
        ``n_steps % thin`` steps still advance the replicas unstored.
        """
        if self.state is None:
            raise RuntimeError("call init_ball first")
        if int(n_steps) > (1 << 30):
            raise ValueError("split runs over 2^30 steps into multiple calls")
        thin = int(thin)
        n_store = int(n_steps) // thin
        leftover = int(n_steps) - n_store * thin
        # bound the scan's device output to ~64 MiB per chunk
        chunk = default_chunk_steps(self.n_walkers, self.n_params, self.dtype)
        from mcmcpp_tpu.chain import run_pipelined

        def launch(take):
            self.state, launched = self._scan_fn(take, thin)(self.state)
            return launched

        def fetch(futures):
            self.chain, appended = append_device_chunk(
                self.chain, futures[0], futures[1]
            )
            return appended

        ok = run_pipelined(n_store, chunk, launch, fetch)
        if ok and leftover:
            fn = self._run_cache.get(("leftover", leftover))
            if fn is None:
                fn = jax.jit(
                    lambda s, t=leftover: jax.lax.fori_loop(
                        0, t, lambda i, x: self._step(x), s
                    )
                )
                self._run_cache[("leftover", leftover)] = fn
            self.state = fn(self.state)
        self._harvest_swaps()
        # rotate the key epoch before the int32 step counter can wrap
        if int(self.state.step) >= (1 << 30):
            self._step_epoch += 1
            self._epoch_key = jax.random.fold_in(
                self._step_key, self._step_epoch
            )
            self.state = self.state._replace(step=jnp.zeros((), jnp.int32))
            self._run_cache.clear()  # cached scans captured the old key
        return ok

    def tune_ladder(self, n_blocks=10, block_steps=100, target=0.4,
                    eta=0.6, min_rate=0.02):
        """Adapt the β ladder toward uniform swap acceptance ≈ ``target``.

        Multiplicative log-spacing updates per block (a simplified
        Vousden-et-al.-style scheme): pairs swapping too often move apart,
        pairs swapping too rarely move together; β[0] stays 1. Call before
        production sampling (the chain is cleared afterwards). Returns self.

        Not available in power-posterior mode: the evidence estimators
        REQUIRE the declared ladder (stepping stone bridges exactly the
        declared Δβ gaps; TI needs the β=0 prior rung, whose log-gap is
        infinite and would be destroyed by the multiplicative update).
        Use ``power_ladder(K, exponent)`` to shape evidence ladders.
        """
        if self._power:
            raise RuntimeError(
                "tune_ladder is not supported in power-posterior mode — "
                "the β=0 rung is required and log-gap tuning would remove "
                "it; shape the ladder with power_ladder(K, exponent)"
            )
        if self.state is None:
            raise RuntimeError("call init_ball first")
        log_gaps = -np.diff(np.log(np.asarray(self.betas, np.float64)))
        for _ in range(int(n_blocks)):
            before_acc = self._swaps_acc_host.copy()
            before_prop = self._swaps_prop_host.copy()
            self.run_mcmc(int(block_steps), thin=int(block_steps))
            d_acc = self._swaps_acc_host - before_acc
            d_prop = np.maximum(self._swaps_prop_host - before_prop, 1)
            rates = np.maximum(d_acc / d_prop, min_rate)
            # too-frequent swaps -> widen the gap; too-rare -> shrink it
            log_gaps = log_gaps * (rates / target) ** eta
            log_gaps = np.clip(log_gaps, 1e-3, 10.0)
            self.betas = jnp.asarray(
                np.exp(-np.concatenate([[0.0], np.cumsum(log_gaps)])),
                self.dtype,
            )
            self._run_cache.clear()  # cached scans captured the old ladder
        self.chain.clear()
        self._swaps_acc_host[:] = 0
        self._swaps_prop_host[:] = 0
        return self

    # -- evidence (power-posterior mode) ------------------------------------

    def reset_evidence(self):
        """Zero the on-device evidence accumulators (call after burn-in,
        before the production run the estimate should be computed from)."""
        if not self._power:
            raise RuntimeError("evidence requires power-posterior mode")
        if self.state is not None:
            self.state = self.state._replace(**self._zero_evidence_acc())
        return self

    def ti_curve(self):
        """(betas ascending, E_β[log L] ascending) — the thermodynamic
        integrand, for diagnostics and custom quadrature."""
        if not self._power:
            raise RuntimeError("evidence requires power-posterior mode")
        betas = np.asarray(self.betas, np.float64)[::-1]
        means = np.asarray(self.state.ll_mean, np.float64)[::-1]
        return betas, means

    def log_evidence(self, method="stepping_stone"):
        """log Z = log ∫ prior·L from the accumulated power-posterior run.

        ``stepping_stone`` (Xie et al. 2011): Σ_k log E_{β_{k+1}}[L^{Δβ_k}],
        each expectation over the LOWER rung's walkers — consistent for any
        ladder and robust to -inf log-likelihoods. ``ti`` (Friel & Pettitt
        2008): trapezoidal ∫_0^1 E_β[log L] dβ — needs a ladder reaching
        β≈0 (``power_ladder``) and finite log L under the prior.
        """
        if not self._power:
            raise RuntimeError("evidence requires power-posterior mode")
        if self.state is None or float(self.state.acc_n) == 0:
            raise RuntimeError("run_mcmc first (no accumulated steps)")
        n = float(self.state.acc_n) * self.n_walkers
        if method == "stepping_stone":
            m = np.asarray(self.state.ss_max, np.float64)
            s = np.asarray(self.state.ss_sum, np.float64)
            terms = m + np.log(np.maximum(s, 1e-300)) - np.log(n)
            return float(np.sum(terms))
        if method == "ti":
            betas, means = self.ti_curve()
            import warnings

            if betas[0] > 1e-6:
                warnings.warn(
                    f"TI ladder starts at β={betas[0]:.4g}, not 0 — the "
                    "integral misses the prior end; use power_ladder",
                    stacklevel=2,
                )
            ll_n = np.asarray(self.state.ll_n, np.float64)
            if (ll_n < float(self.state.acc_n)).any():
                warnings.warn(
                    "some rungs had steps with non-finite mean log L "
                    "(hard-constraint likelihood); the TI integrand is "
                    "conditioned on finite steps and may be biased — "
                    "prefer stepping_stone",
                    stacklevel=2,
                )
            return float(np.trapezoid(means, betas))
        raise ValueError(f"unknown method {method!r}")

    @property
    def swap_acceptance(self):
        """Per-ladder-pair swap acceptance rates, (K-1,)."""
        prop = (self._swaps_prop_host
                + np.asarray(self.state.swaps_proposed, np.int64)).astype(
                    np.float64)
        acc = (self._swaps_acc_host
               + np.asarray(self.state.swaps_accepted, np.int64)).astype(
                   np.float64)
        return np.where(prop > 0, acc / np.maximum(prop, 1), 0.0)

    def get_samples(self, burn_in=0, thin=1, flat=False):
        """Cold-chain (β=1) samples."""
        return self.chain.get(burn_in=burn_in, thin=thin, flat=flat)

    def get_log_probs(self, burn_in=0, thin=1, flat=False):
        """Cold-chain RAW log-posteriors (stored untempered)."""
        return self.chain.get_logp(burn_in=burn_in, thin=thin, flat=flat)
