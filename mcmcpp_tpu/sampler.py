"""Ensemble sampler: red/black half-ensemble stepping under ``lax.scan``.

accelerator-native rebuild of ``MCMCpp/EnsembleSampler.h`` (sequential) and
``MCMCpp/ParallelEnsembleSampler.h`` (pthread pool) as ONE code path:

- The walker ensemble is two device arrays ``(W/2, P)`` (red/black halves)
  plus log-posterior vectors, not W heap objects
  (cf. Walker layer, ``MCMCpp/Walker/Walker.h:42-150``).
- ``performStep`` (EnsembleSampler.h:342-359) becomes a pure function:
  red half updates against black, then black against the *new* red, both
  as vmapped Metropolis updates. The two pthread barriers per step
  (RedBlkCtrlerSpinLock.h:241-322) are implicit in SPMD data flow.
- ``runMCMC`` (EnsembleSampler.h:285-331) becomes ``lax.scan`` over stored
  steps with an inner ``fori_loop`` for thinning; chain rows are scan
  outputs, fetched to a host :class:`~mcmcpp_tpu.chain.Chain` in chunks.
- pcg64 seed/stream multiplexing is replaced by threefry key folding on the
  global step counter — bitwise deterministic at any device count, which
  the threaded reference explicitly is not (ParallelEnsembleSampler.h:71-76).

The same step function runs single-chip or sharded over a
``jax.sharding.Mesh`` (see ``mcmcpp_tpu.parallel``).
"""

from functools import partial
from typing import Any, NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from mcmcpp_tpu.chain import (
    Chain,
    append_device_chunk,
    default_chunk_steps,
    fetch_addressable,
)
from mcmcpp_tpu.movers.base import Mover
from mcmcpp_tpu.movers.stretch import StretchMove
from mcmcpp_tpu.ops.random import split_for_step


class EnsembleState(NamedTuple):
    """Carry for the sampling scan. ``red``/``black``: (W/2, P);
    ``logp_*``: (W/2,); ``accepted_red``/``accepted_black``: (W/2,) int32
    PER-WALKER accept counters (≙ the reference's per-walker bookkeeping,
    ``MCMCpp/Walker/Walker.h:111-122``), sharded exactly like the logp
    vectors so the hot loop never reshards, harvested to host accumulators
    per chunk; ``step``: global step counter (drives key folding,
    epoch-rebased before it can wrap)."""

    red: jax.Array
    black: jax.Array
    logp_red: jax.Array
    logp_black: jax.Array
    accepted_red: jax.Array
    accepted_black: jax.Array
    step: jax.Array


def init_state(positions, batched_logp):
    """Build an :class:`EnsembleState` from initial walker positions (W, P).

    Equivalent to ``setInitialWalkerPos`` (EnsembleSampler.h:221-243): the
    first W/2 walkers become the red half, the rest black, and the
    log-posterior is evaluated once up front.
    """
    positions = jnp.asarray(positions)
    w = positions.shape[0]
    if w % 2 != 0:
        raise ValueError("number of walkers must be even (red/black halves)")
    half = w // 2
    red, black = positions[:half], positions[half:]
    return EnsembleState(
        red=red,
        black=black,
        logp_red=batched_logp(red),
        logp_black=batched_logp(black),
        accepted_red=jnp.zeros((half,), jnp.int32),
        accepted_black=jnp.zeros((half,), jnp.int32),
        step=jnp.zeros((), jnp.int32),
    )


def make_step_fn(batched_logp, mover: Mover, mover_state: Any, base_key):
    """Return ``step(state) -> state`` performing one full red+black update."""

    def step(state: EnsembleState) -> EnsembleState:
        k_red, k_black = split_for_step(base_key, state.step)
        red, logp_red, acc_r = mover.update_half(
            k_red, state.red, state.logp_red, state.black, batched_logp, mover_state
        )
        # black proposes against the *updated* red half (EnsembleSampler.h:350-354)
        black, logp_black, acc_b = mover.update_half(
            k_black, state.black, state.logp_black, red, batched_logp, mover_state
        )
        # per-walker counters: one fused elementwise add per half, no
        # reduction and no resharding in the hot loop (Walker.h:111-122)
        accepted_red = state.accepted_red + acc_r.astype(jnp.int32)
        accepted_black = state.accepted_black + acc_b.astype(jnp.int32)
        return EnsembleState(red, black, logp_red, logp_black,
                             accepted_red, accepted_black, state.step + 1)

    return step


@partial(jax.jit, static_argnames=("step_fn", "n_store", "thin", "step_action",
                                   "store_dtype"))
def run_scan(state: EnsembleState, step_fn, n_store: int, thin: int,
             step_action=None, store_dtype=None):
    """Run ``n_store·thin`` steps, emitting every ``thin``-th ensemble.

    Returns (final_state, positions (n_store, W, P), logps (n_store, W),
    metrics). Thinning-at-source replaces the reference's save/skip
    bookkeeping (EnsembleSampler.h:296-308) — skipped steps never touch HBM.

    ``step_action(positions (W, P), logps (W)) -> pytree`` is the jitted
    equivalent of the reference's PostStepAction hook (called once per
    completed stored step, ≙ EnsembleSampler.h:356-359); its outputs are
    stacked along the leading axis and returned as ``metrics`` (None if no
    action given).

    ``store_dtype`` (e.g. ``jnp.bfloat16``) down-casts the emitted chunk
    INSIDE the scan body — the compute path stays full precision while the
    stored rows cost half the HBM scan-output footprint and half the
    device->host offload bytes (step_action still sees full precision).
    """

    def body(carry, _):
        carry = jax.lax.fori_loop(0, thin, lambda i, s: step_fn(s), carry)
        pos = jnp.concatenate([carry.red, carry.black], axis=0)
        logp = jnp.concatenate([carry.logp_red, carry.logp_black], axis=0)
        metrics = step_action(pos, logp) if step_action is not None else 0
        if store_dtype is not None:
            pos = pos.astype(store_dtype)
            # 8-bit float tiers keep the logp plane at bfloat16: e4m3's
            # ±448 range overflows on routine |logp| values, and the plane
            # is 1/(P+1) of the payload — the byte saving is negligible
            logp = logp.astype(
                jnp.bfloat16 if jnp.dtype(store_dtype).itemsize < 2
                else store_dtype
            )
        return carry, (pos, logp, metrics)

    final, (positions, logps, metrics) = jax.lax.scan(body, state, length=n_store)
    if step_action is None:
        metrics = None
    # emit the chunk's per-walker accept counters and zero the carried ones
    # so the driver can harvest asynchronously (int32-safe per chunk; the
    # pipelined store loop never syncs on the in-flight chunk)
    accepted = (final.accepted_red, final.accepted_black)
    final = final._replace(
        accepted_red=jnp.zeros_like(final.accepted_red),
        accepted_black=jnp.zeros_like(final.accepted_black),
    )
    return final, positions, logps, metrics, accepted


@partial(jax.jit, static_argnames=("step_fn", "n_steps"))
def run_nostore(state: EnsembleState, step_fn, n_steps: int):
    """Advance ``n_steps`` without storing (burn-in fast path)."""
    return jax.lax.fori_loop(0, n_steps, lambda i, s: step_fn(s), state)


def sample_ball(key, center, scale, n_walkers, dtype=jnp.float32):
    """Gaussian ball initializer for walker positions (emcee-style)."""
    center = jnp.asarray(center, dtype)
    scale = jnp.broadcast_to(jnp.asarray(scale, dtype), center.shape)
    z = jax.random.normal(key, (n_walkers, center.shape[0]), dtype)
    return center[None, :] + scale[None, :] * z


class EnsembleSampler:
    """User-facing driver (public surface ≙ EnsembleSampler.h:89-176).

    Parameters
    ----------
    logp_fn : callable(theta (P,)) -> scalar log-posterior, JAX-traceable.
        The reference's compile-time SFINAE check on the user Calculator
        (UserOjbectsTest.h:144-151) becomes an ``eval_shape`` validation here.
    n_walkers, n_params : ensemble dimensions (W must be even).
    mover : a :class:`~mcmcpp_tpu.movers.base.Mover` (default StretchMove).
    seed : base PRNG seed (threefry).
    max_chain_bytes : host chain capacity (default 2 GiB, ≙ EnsembleSampler.h:67).
    batched : set True if logp_fn already maps (n, P) -> (n,).
    prng_impl : "threefry2x32" (default; bitwise reproducible at any device
        count) or "rbg" (XLA RngBitGenerator; reproducible per fixed
        backend/topology only).
    store_dtype : optional reduced-precision dtype for STORED rows only
        (e.g. ``jnp.bfloat16``): the sampling compute path stays ``dtype``,
        but chunks are down-cast on device before the device->host offload
        — halving both the chain's scan-output HBM footprint and the
        offload bytes. ``get_samples``/``get_log_probs`` cast back up to
        float32 for analysis (bf16 keeps float32's full exponent range;
        the ~3-decimal-digit mantissa shifts moments/ACT well within Monte
        Carlo error — see tests/test_store_dtype.py).
    """

    def __init__(
        self,
        logp_fn,
        n_walkers,
        n_params,
        mover=None,
        seed=0,
        dtype=jnp.float32,
        max_chain_bytes=2 << 30,
        batched=False,
        store_chunk_steps=None,
        prng_impl="threefry2x32",
        chain=None,
        store_dtype=None,
    ):
        if n_walkers % 2 != 0:
            raise ValueError("n_walkers must be even")
        if n_walkers < 4:
            raise ValueError("need at least 4 walkers")
        self.n_walkers = int(n_walkers)
        self.n_params = int(n_params)
        self.dtype = dtype
        self.mover = mover if mover is not None else StretchMove()
        self._logp_fn = logp_fn
        self._batched_logp = logp_fn if batched else jax.vmap(logp_fn)
        self._validate_logp()
        self._mover_state = self.mover.init_state(self.n_params, dtype)
        self._key = jax.random.key(seed, impl=prng_impl)
        # domain-separated keys: steps fold the step counter into _step_key,
        # aux draws (init_ball etc.) use _aux_key — no stream can collide
        self._step_key, self._aux_key = jax.random.split(self._key)
        # the int32 step counter is rebased to 0 (and the stream rotated to
        # a new epoch) once it crosses 2^30, so multi-week runs never wrap
        self._step_epoch = 0
        self._epoch_base_steps = 0
        self._store_dtype = (
            None if store_dtype is None
            else jax.dtypes.canonicalize_dtype(store_dtype)
        )
        if chain is not None:
            # injected store (e.g. chain_disk.DiskChain for histories larger
            # than host RAM); must match the ensemble geometry
            if (chain.n_walkers, chain.n_params) != (
                self.n_walkers, self.n_params,
            ):
                raise ValueError(
                    f"chain store geometry ({chain.n_walkers}, "
                    f"{chain.n_params}) != ({self.n_walkers}, {self.n_params})"
                )
            if (
                self._store_dtype is not None
                and np.dtype(self._store_dtype).itemsize < 2
                and np.dtype(getattr(chain, "logp_dtype", chain.dtype)
                             ).itemsize < 2
            ):
                # run_scan emits the logp plane as bf16 under 8-bit sample
                # tiers (e4m3 range); an injected store that would squash
                # it back to 8 bits silently overflows |logp| > 448
                raise ValueError(
                    "an 8-bit store_dtype needs an injected chain whose "
                    "logp plane is at least 16-bit (e.g. Chain(..., "
                    "dtype=f8, logp_dtype=bfloat16)); this chain holds "
                    f"logp at {getattr(chain, 'logp_dtype', chain.dtype)}"
                )
            self.chain = chain
        else:
            row_dtype = np.dtype(jax.dtypes.canonicalize_dtype(
                dtype if self._store_dtype is None else self._store_dtype
            ))
            self.chain = Chain(
                n_walkers=self.n_walkers,
                n_params=self.n_params,
                max_bytes=max_chain_bytes,
                dtype=row_dtype,
                # sub-fp32 rows are cast up on read: numpy's FFT/cov
                # analysis paths reject ml_dtypes customs
                read_dtype=(np.float32 if row_dtype.itemsize < 4 else None),
                # 8-bit tiers keep the logp plane at bf16 (run_scan's rule)
                logp_dtype=(np.dtype(jnp.bfloat16)
                            if row_dtype.itemsize < 2 else None),
            )
        self.state = None
        # host-side accumulators: PER-WALKER int64 accept counts in chain
        # column order [red..., black...] (local shard under multi-host)
        # plus the GLOBAL scalar total (identical on every host — a
        # replicated statistic). Device counters are int32 and harvested
        # after every chunk, so runs of >2^31 updates per walker can't
        # overflow.
        self._accepted_walkers_host = None
        self._accepted_global_host = 0
        self._steps_host = 0
        self._rebuild_step_fn()
        if store_chunk_steps is None:
            # bound device-side scan output to ~64 MiB per chunk (sized at
            # the STORED row dtype, so bf16 stores fit 2x the steps)
            store_chunk_steps = default_chunk_steps(
                self.n_walkers, self.n_params, self.chain.dtype
            )
        self._chunk = int(store_chunk_steps)

    # -- setup -----------------------------------------------------------

    def _effective_step_key(self):
        return jax.random.fold_in(self._step_key, self._step_epoch)

    def _rebuild_step_fn(self):
        """(Re)build the step closure; overridden by the sharded sampler."""
        self._step_fn = make_step_fn(
            self._batched_logp, self.mover, self._mover_state,
            self._effective_step_key(),
        )

    def _maybe_rebase_steps(self):
        """Rotate to a fresh key epoch before the int32 step counter can
        wrap (wrapping would repeat threefry streams)."""
        cur = int(self.state.step)
        if cur < (1 << 30):
            return
        self._step_epoch += 1
        self._epoch_base_steps += cur
        self._reset_step_base = getattr(self, "_reset_step_base", 0) - cur
        self.state = self.state._replace(step=jnp.zeros((), jnp.int32))
        self._rebuild_step_fn()

    def _validate_logp(self):
        """Shape-check the user's logp at wrap time (replaces SFINAE)."""
        try:
            out = jax.eval_shape(
                self._batched_logp,
                jax.ShapeDtypeStruct((self.n_walkers // 2, self.n_params), self.dtype),
            )
        except Exception as e:  # noqa: BLE001 - re-raise with context
            raise TypeError(
                "logp_fn is not traceable over a (n, P) batch; it must map a "
                "(P,) parameter vector to a scalar log-posterior (or set "
                "batched=True for a (n, P)->(n,) function)"
            ) from e
        if out.shape != (self.n_walkers // 2,):
            raise TypeError(
                f"batched logp returned shape {out.shape}, expected "
                f"({self.n_walkers // 2},); logp_fn must return a scalar"
            )

    def set_initial_walker_pos(self, positions):
        """≙ setInitialWalkerPos (EnsembleSampler.h:221). (W, P) array."""
        positions = jnp.asarray(positions, self.dtype)
        if positions.shape != (self.n_walkers, self.n_params):
            raise ValueError(
                f"positions shape {positions.shape} != "
                f"({self.n_walkers}, {self.n_params})"
            )
        self.state = init_state(positions, self._batched_logp)
        return self

    def init_ball(self, center, scale=1e-2, seed=None):
        """Initialize walkers in a Gaussian ball around ``center``."""
        key = self._aux_key if seed is None else jax.random.key(seed)
        key = jax.random.fold_in(key, 0x1B17)
        pos = sample_ball(key, center, scale, self.n_walkers, self.dtype)
        return self.set_initial_walker_pos(pos)

    # -- running ---------------------------------------------------------

    def _require_state(self):
        if self.state is None:
            raise RuntimeError(
                "walkers not initialized; call set_initial_walker_pos/init_ball"
            )

    @staticmethod
    def _global_accept_sum(acc_red, acc_black):
        """Global scalar accept total of one harvest — replicated across
        hosts (a psum over the sharded walker axis under SPMD)."""
        if getattr(acc_red, "is_fully_addressable", True):
            return int(np.asarray(acc_red).sum()) + int(
                np.asarray(acc_black).sum()
            )
        total = jax.jit(lambda a, b: jnp.sum(a) + jnp.sum(b))(
            acc_red, acc_black
        )
        return int(total)

    def _accum_accept(self, acc_red, acc_black):
        """Fold per-walker device accept counters into the host int64 vector.

        Under multi-host each process accumulates only ITS walker shards, in
        the same [red_local, black_local] order as the chain columns; the
        scalar total is accumulated globally (identical on all hosts).
        """
        self._accepted_global_host += self._global_accept_sum(
            acc_red, acc_black
        )
        vec = np.concatenate([
            fetch_addressable(acc_red, walker_axis=0),
            fetch_addressable(acc_black, walker_axis=0),
        ]).astype(np.int64)
        if self._accepted_walkers_host is None:
            self._accepted_walkers_host = vec
        else:
            self._accepted_walkers_host += vec

    def _harvest_counters(self):
        """Move device accept counters into the host accumulator (int32-safe)."""
        self._accum_accept(self.state.accepted_red, self.state.accepted_black)
        self.state = self.state._replace(
            accepted_red=jnp.zeros_like(self.state.accepted_red),
            accepted_black=jnp.zeros_like(self.state.accepted_black),
        )

    def _append_chain(self, pos, logp):
        """Fetch (S, W, P)/(S, W) device chunks and append to the chain.

        Under multi-host, each process fetches and stores only its walker
        shard; the chain is resized to the local width on first use
        (shared store path: chain.append_device_chunk).
        """
        self.chain, ok = append_device_chunk(self.chain, pos, logp)
        return ok

    def store_current_walker_positions(self):
        """≙ storeCurrentWalkerPositions (EnsembleSampler.h:249): push the
        current ensemble into the chain as one stored step."""
        self._require_state()
        pos = jnp.concatenate([self.state.red, self.state.black], axis=0)[None]
        logp = jnp.concatenate(
            [self.state.logp_red, self.state.logp_black]
        )[None]
        return self._append_chain(pos, logp)

    def set_sampling_mode(self, thin):
        """Default thinning interval applied by subsequent ``run_mcmc``
        calls that don't pass ``thin``."""
        self._default_thin = int(thin)
        return self

    def set_slicing_mode(self, use_slicing=False, slicing_interval=1):
        """≙ setSlicingMode (EnsembleSampler.h:137,325-329): toggle
        sub-sampling and set its interval in one call."""
        self._default_thin = int(slicing_interval) if use_slicing else 1
        return self

    def run_mcmc(self, n_steps, thin=None, store=True, step_action=None,
                 chunk_action=None, checkpoint_path=None, checkpoint_every=1):
        """Run ``n_steps`` total steps; if ``store``, save every ``thin``-th.

        Returns False if the chain hit its byte capacity before finishing
        (≙ IncrementStatus::EndOfChain, Chain/Chain.h:230-234), else True.

        ``step_action``: jittable ``(positions (W, P), logps (W)) -> pytree``
        run on-device once per stored step — the PostStepAction hook of the
        reference (EnsembleSampler.h:356-359, NoAction.h default) in jitted
        form; results accumulate in ``self.step_metrics`` (leaves stacked
        over steps). ``chunk_action(chain)`` runs on host after each chunk
        lands (streaming writers / convergence monitors).

        ``checkpoint_path``: if set, a full resumable checkpoint
        (io.checkpoint) is written after every ``checkpoint_every`` chunks —
        crash recovery for long runs (the reference has none, SURVEY.md §5).
        The store pipeline is drained before each save, so snapshots are
        exactly consistent (state == chain == counters); saves are atomic.
        """
        self._require_state()
        if int(n_steps) > (1 << 30):
            raise ValueError(
                "split runs over 2^30 steps into multiple run_mcmc calls "
                "(the int32 step counter is rebased between calls)"
            )
        self.step_metrics = None
        # keep any single device launch under 2^31 walker-updates so the
        # int32 accept counters cannot overflow before being harvested
        max_micro = max(1, getattr(self, "_max_micro_updates", 1 << 30)
                        // self.n_walkers)
        if not store:
            remaining = int(n_steps)
            while remaining > 0:
                take = min(remaining, max_micro)
                self.state = run_nostore(self.state, self._step_fn, take)
                self._harvest_counters()
                remaining -= take
            self._maybe_rebase_steps()
            return True
        thin = int(thin) if thin is not None else getattr(self, "_default_thin", 1)
        n_store = int(n_steps) // thin
        leftover = int(n_steps) - n_store * thin
        if thin > max_micro:
            # one stored row would exceed the int32-safe launch size: advance
            # in harvested micro-chunks, then store the row explicitly
            ok = True
            for _ in range(n_store):
                self.run_mcmc(thin - 1, store=False)
                self.state = run_nostore(self.state, self._step_fn, 1)
                self._harvest_counters()
                ok = self.store_current_walker_positions()
                if chunk_action is not None:
                    chunk_action(self.chain)
                if not ok:
                    return False
            if leftover:
                self.run_mcmc(leftover, store=False)
            return ok
        # shared pipelined store loop (chain.run_pipelined) — ONE copy of
        # the launch/fetch/on_drop/checkpoint-drain machine for every
        # chunked driver (the reference's analogous duplicated controller
        # code is where its sub-sampling resume bug lived,
        # RedBlkCtrlerSpinLock.h:297-300 vs EnsembleSampler.h:296-308)
        from mcmcpp_tpu.chain import run_pipelined

        chunk = min(self._chunk, max(1, max_micro // thin))
        metric_chunks = []

        def launch(take):
            # JAX dispatch is async: chunk k's device compute overlaps
            # chunk k-1's device->host copy
            self.state, pos, logp, metrics, acc = run_scan(
                self.state, self._step_fn, take, thin, step_action,
                store_dtype=self._store_dtype,
            )
            return (pos, logp, metrics, acc)

        def fetch(chunk_data):
            """Append one chunk's futures to the chain; returns append ok."""
            p_pos, p_logp, p_metrics, p_acc = chunk_data
            ok = self._append_chain(p_pos, p_logp)
            self._accum_accept(*p_acc)
            if p_metrics is not None:
                metric_chunks.append(jax.tree.map(np.asarray, p_metrics))
            if chunk_action is not None:
                chunk_action(self.chain)
            return ok

        def on_drop(chunk_data):
            # the launched-but-unstorable chunk still advanced the state;
            # fold its accept counts in before bailing
            self._accum_accept(*chunk_data[3])

        ckpt_save = None
        if checkpoint_path is not None:
            from mcmcpp_tpu.io.checkpoint import save_checkpoint

            def ckpt_save():
                save_checkpoint(self, checkpoint_path)

        ok = run_pipelined(
            n_store, chunk, launch, fetch, on_drop=on_drop,
            checkpoint_save=ckpt_save, checkpoint_every=checkpoint_every,
        )
        if metric_chunks:
            self.step_metrics = jax.tree.map(
                lambda *xs: np.concatenate(xs, axis=0), *metric_chunks
            )
        if not ok:
            return False
        if leftover:
            self.state = run_nostore(self.state, self._step_fn, leftover)
            self._harvest_counters()
        self._maybe_rebase_steps()
        if checkpoint_path is not None:
            from mcmcpp_tpu.io.checkpoint import save_checkpoint

            save_checkpoint(self, checkpoint_path)  # final consistent snapshot
        return True

    def reset(self):
        """≙ reset (EnsembleSampler.h:97): clear chain + counters, keep
        current walker positions so sampling can restart from here."""
        self._require_state()
        self.chain.clear()
        self._accepted_walkers_host = None
        self._accepted_global_host = 0
        self._steps_host += int(self.state.step) - getattr(
            self, "_reset_step_base", 0
        )
        # step counter keeps growing so threefry keys never repeat; the
        # public counters below are relative to the last reset
        self._reset_step_base = int(self.state.step)
        self.state = self.state._replace(
            accepted_red=jnp.zeros_like(self.state.accepted_red),
            accepted_black=jnp.zeros_like(self.state.accepted_black),
        )
        return self

    # -- statistics & access ----------------------------------------------

    @property
    def total_steps(self):
        """Total walker-updates since last reset (W per step), ≙ getTotalSteps."""
        self._require_state()
        base = getattr(self, "_reset_step_base", 0)
        return (int(self.state.step) - base) * self.n_walkers

    @property
    def per_walker_accepted(self):
        """(W_local,) int64 accepted-move counts per walker since the last
        reset, in chain column order [red..., black...] — true per-walker
        bookkeeping (≙ ``MCMCpp/Walker/Walker.h:111-122``; aggregated on
        demand like ``EnsembleSampler.h:245-282``). A walker pinned in a
        logp=-inf region shows up here as a zero. Under multi-host this is
        the LOCAL walker shard (matching the local chain columns)."""
        self._require_state()
        dev = np.concatenate([
            fetch_addressable(self.state.accepted_red, walker_axis=0),
            fetch_addressable(self.state.accepted_black, walker_axis=0),
        ]).astype(np.int64)
        if self._accepted_walkers_host is not None:
            dev = dev + self._accepted_walkers_host
        return dev

    @property
    def per_walker_acceptance(self):
        """(W_local,) per-walker acceptance fractions since the last reset."""
        base = getattr(self, "_reset_step_base", 0)
        steps = int(self.state.step) - base
        counts = self.per_walker_accepted
        if steps == 0:
            return np.zeros_like(counts, dtype=np.float64)
        return counts / steps

    @property
    def accepted_steps(self):
        """≙ getAcceptedSteps (GLOBAL total; identical on every host)."""
        self._require_state()
        return self._accepted_global_host + self._global_accept_sum(
            self.state.accepted_red, self.state.accepted_black
        )

    @property
    def acceptance_fraction(self):
        """≙ getAcceptanceFraction (EnsembleSampler.h:245-282)."""
        t = self.total_steps
        return self.accepted_steps / t if t else 0.0

    @property
    def stored_steps(self):
        """≙ getStoredSteps."""
        return self.chain.n_steps

    def get_samples(self, burn_in=0, thin=1, flat=False):
        """Chain samples (S, W, P) (or flattened (S·W, P))."""
        return self.chain.get(burn_in=burn_in, thin=thin, flat=flat)

    def get_log_probs(self, burn_in=0, thin=1, flat=False):
        return self.chain.get_logp(burn_in=burn_in, thin=thin, flat=flat)

    def slice_and_burn_chain(self, thin, burn_in):
        """≙ sliceAndBurnChain (EnsembleSampler.h:333): in-place chain
        compaction to every ``thin``-th step after ``burn_in``."""
        self.chain.compact(burn_in=burn_in, thin=thin)
        return self

    @property
    def current_positions(self):
        self._require_state()
        return jnp.concatenate([self.state.red, self.state.black], axis=0)
