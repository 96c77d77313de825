"""Host-side chain store for sampled ensembles.

Accelerator-native replacement for the reference's linked list of fixed-size blocks
(``MCMCpp/Chain/Chain.h``, ``MCMCpp/Chain/ChainBlock.h``): on an accelerator the chain
must NOT live in HBM (it is write-once history), so stored steps stream
host-ward in chunks and land in a block list here. Byte-capped exactly like
the reference (default 2 GiB, ``EnsembleSampler.h:67``); appends past
capacity return False (≙ ``IncrementStatus::EndOfChain``, Chain.h:230-234).

The reference's two iterator types (ChainPsetIterator / ChainStepIterator)
collapse into NumPy views: ``get()`` returns (S, W, P) (step iteration) and
``get(flat=True)`` returns (S·W, P) (pset iteration). ``compact`` is the
in-place burn+thin compaction of ``resetChainForSubSampling``
(Chain.h:269-305).

When the native C++ block store extension is built (``mcmcpp_tpu/native``),
it backs the block list with 64-byte-aligned arena blocks; this pure-NumPy
path is the always-available fallback with identical semantics.
"""

import numpy as np


def fetch_addressable(arr, walker_axis):
    """Host-fetch an array that may span non-addressable devices.

    Fully-addressable (single-host) arrays round-trip through
    ``np.asarray``. Under multi-host SPMD each process assembles only ITS
    walker shards (deduplicated, ordered by global offset) — chains are
    stored per host (see parallel/distributed.py).
    """
    if getattr(arr, "is_fully_addressable", True):
        return np.asarray(arr)
    parts = {}
    for s in arr.addressable_shards:
        sl = s.index[walker_axis]
        start = 0 if sl.start is None else int(sl.start)
        if start not in parts:
            parts[start] = np.asarray(s.data)
    return np.concatenate([parts[k] for k in sorted(parts)], axis=walker_axis)


def append_device_chunk(chain, pos, logp):
    """Shared multi-host-safe store path for ALL engine drivers.

    Fetches (S, W, P)/(S, W) device chunks — only the addressable walker
    shards under multi-host SPMD — and appends them to ``chain``. If the
    local shard width differs from the chain's configured width (first
    append of a multi-host run), the chain is rebuilt at the local width.
    Returns ``(chain, ok)`` where ok=False means the byte cap was hit
    (≙ IncrementStatus::EndOfChain, ``MCMCpp/Chain/Chain.h:230-234``).
    """
    pos_np = fetch_addressable(pos, walker_axis=1)
    logp_np = fetch_addressable(logp, walker_axis=1)
    if pos_np.shape[1] != chain.n_walkers:
        if chain.n_steps:
            raise RuntimeError(
                "chain walker width changed mid-run (sharding changed?)"
            )
        chain = Chain(
            n_walkers=pos_np.shape[1],
            n_params=chain.n_params,
            max_bytes=chain.max_bytes,
            dtype=chain.dtype,
            read_dtype=chain.read_dtype,
        )
    return chain, chain.append(pos_np, logp_np)


def default_chunk_steps(n_rows, n_params, dtype, budget_bytes=64 << 20):
    """Steps per device->host chunk bounding scan output to ~budget_bytes.

    One stored step costs n_rows·(n_params+1)·itemsize (positions + logp);
    shared by the ensemble, gradient, and tempering drivers.
    """
    row = int(n_rows) * (int(n_params) + 1) * np.dtype(dtype).itemsize
    return max(1, int(budget_bytes) // max(row, 1))


def run_pipelined(n_store, chunk, launch, fetch, on_drop=None,
                  checkpoint_save=None, checkpoint_every=1):
    """Shared async launch/fetch store loop for ALL chunked drivers.

    ``launch(take) -> futures`` dispatches the next device chunk (JAX
    dispatch is async, so chunk k overlaps chunk k-1's device->host copy);
    ``fetch(futures) -> bool`` lands one chunk (False = byte cap hit,
    EndOfChain ≙ ``MCMCpp/Chain/Chain.h:230-234``). ``on_drop(futures)``
    runs on the already-launched-but-unstorable chunk when the cap hits
    (its transitions still advanced the sampler state — fold statistics
    in, don't store). ``checkpoint_save()`` is called every
    ``checkpoint_every`` fetched chunks with the pipeline DRAINED first,
    so snapshots are exactly consistent. Returns ok.
    """
    done, fetched, ok, pending = 0, 0, True, None
    ckpt_every = max(1, int(checkpoint_every))
    while done < n_store or pending is not None:
        if done < n_store:
            take = min(chunk, n_store - done)
            launched = launch(take)
            done += take
        else:
            launched = None
        if pending is not None:
            if not fetch(pending):
                ok = False
                if launched is not None and on_drop is not None:
                    on_drop(launched)
                pending = None
                break
            fetched += 1
            if checkpoint_save is not None and fetched % ckpt_every == 0:
                if launched is not None:  # drain the in-flight chunk
                    if not fetch(launched):
                        ok = False
                        launched = None
                        break
                    fetched += 1
                    launched = None
                checkpoint_save()
        pending = launched
    return ok


class Chain:
    """Append-only (step, walker, param) store with byte capacity.

    Blocks are whatever chunk sizes the producer appends; views returned by
    :meth:`get` are materialized as one contiguous array on demand and
    cached until the chain changes.
    """

    def __init__(self, n_walkers, n_params, max_bytes=2 << 30, dtype=np.float32,
                 backend="auto", read_dtype=None, logp_dtype=None):
        self.n_walkers = int(n_walkers)
        self.n_params = int(n_params)
        self.max_bytes = int(max_bytes)
        self.dtype = np.dtype(dtype)
        # reduced-precision store support: rows are HELD at ``dtype`` (e.g.
        # bfloat16, halving the offload payload) but handed to analysis
        # cast up to ``read_dtype`` (numpy FFT/cov paths don't accept
        # ml_dtypes customs)
        self.read_dtype = None if read_dtype is None else np.dtype(read_dtype)
        # the logp plane may carry a wider dtype than the sample rows (f8
        # sample tiers keep logp at bf16 — range, see sampler.run_scan)
        self.logp_dtype = (self.dtype if logp_dtype is None
                           else np.dtype(logp_dtype))
        self._blocks = []  # list of (S_i, W, P)
        self._logp_blocks = []  # list of (S_i, W)
        self._bytes = 0
        self._cache = None
        self._logp_cache = None
        self._native = None
        if backend not in ("auto", "native", "numpy"):
            raise ValueError(f"unknown chain backend {backend!r}")
        if self.logp_dtype != self.dtype and backend == "native":
            raise ValueError(
                "the native store holds both planes at one dtype; "
                "mixed sample/logp dtypes need backend='numpy'"
            )
        if backend == "auto" and self.logp_dtype != self.dtype:
            backend = "numpy"  # mixed-plane layout: host store only
        if backend in ("auto", "native"):
            from mcmcpp_tpu import native as _nat

            if _nat.available():
                self._native = _nat.NativeChainStore(
                    self.n_walkers, self.n_params, self.max_bytes, self.dtype
                )
            elif backend == "native":
                raise RuntimeError(
                    "native chain store not built; run `make -C mcmcpp_tpu/native`"
                )

    @property
    def backend(self):
        return "native" if self._native is not None else "numpy"

    # -- writing -----------------------------------------------------------

    def _row_bytes(self):
        return self.n_walkers * (
            self.n_params * self.dtype.itemsize + self.logp_dtype.itemsize
        )

    def append(self, positions, logps=None):
        """Append (S, W, P) positions (+ optional (S, W) logp). Returns False
        (and appends nothing beyond capacity) once the byte cap is reached."""
        positions = np.asarray(positions, self.dtype)
        if positions.ndim != 3 or positions.shape[1:] != (
            self.n_walkers,
            self.n_params,
        ):
            raise ValueError(
                f"expected (S, {self.n_walkers}, {self.n_params}), "
                f"got {positions.shape}"
            )
        if logps is None:
            logps = np.zeros(positions.shape[:2], self.logp_dtype)
        else:
            logps = np.asarray(logps, self.logp_dtype)
            if logps.shape != positions.shape[:2]:
                raise ValueError("logps shape must be (S, W)")
        if self._native is not None:
            ok = self._native.append(positions, logps)
            self._cache = None
            self._logp_cache = None
            return ok
        room = (self.max_bytes - self._bytes) // self._row_bytes()
        take = min(positions.shape[0], max(room, 0))
        if take > 0:
            self._blocks.append(positions[:take])
            self._logp_blocks.append(logps[:take])
            self._bytes += take * self._row_bytes()
            self._cache = None
            self._logp_cache = None
        return take == positions.shape[0]

    def clear(self):
        """Drop all stored steps (≙ Chain reset via sampler.reset)."""
        if self._native is not None:
            self._native.clear()
        self._blocks = []
        self._logp_blocks = []
        self._bytes = 0
        self._cache = None
        self._logp_cache = None

    # -- reading -----------------------------------------------------------

    @property
    def n_steps(self):
        if self._native is not None:
            return self._native.n_steps
        return sum(b.shape[0] for b in self._blocks)

    @property
    def nbytes(self):
        if self._native is not None:
            return self._native.nbytes
        return self._bytes

    def _materialize(self):
        if self._cache is None:
            if self._native is not None:
                self._cache, self._logp_cache = self._native.read()
            elif self._blocks:
                self._cache = (
                    self._blocks[0]
                    if len(self._blocks) == 1
                    else np.concatenate(self._blocks, axis=0)
                )
            else:
                self._cache = np.zeros(
                    (0, self.n_walkers, self.n_params), self.dtype
                )
        return self._cache

    def _materialize_logp(self):
        if self._logp_cache is None:
            if self._native is not None:
                self._cache, self._logp_cache = self._native.read()
            elif self._logp_blocks:
                self._logp_cache = (
                    self._logp_blocks[0]
                    if len(self._logp_blocks) == 1
                    else np.concatenate(self._logp_blocks, axis=0)
                )
            else:
                self._logp_cache = np.zeros(
                    (0, self.n_walkers), self.logp_dtype
                )
        return self._logp_cache

    def get(self, burn_in=0, thin=1, flat=False):
        """Samples as (S, W, P); ``flat`` flattens steps×walkers to rows
        (pset-iterator order: step-major, walker-minor)."""
        arr = self._materialize()[burn_in::thin]
        if self.read_dtype is not None and arr.dtype != self.read_dtype:
            arr = arr.astype(self.read_dtype)
        if flat:
            return arr.reshape(-1, self.n_params)
        return arr

    def get_logp(self, burn_in=0, thin=1, flat=False):
        arr = self._materialize_logp()[burn_in::thin]
        if self.read_dtype is not None and arr.dtype != self.read_dtype:
            arr = arr.astype(self.read_dtype)
        if flat:
            return arr.reshape(-1)
        return arr

    def iter_steps(self, burn_in=0, thin=1):
        """Yield one (W, P) array per stored step — the generator analogue
        of ChainStepIterator (``Chain/ChainStepIterator.h``)."""
        arr = self.get(burn_in=burn_in, thin=thin)
        for row in arr:
            yield row

    def iter_psets(self, burn_in=0, thin=1):
        """Yield one (P,) parameter set per walker per step (step-major,
        walker-minor) — the analogue of ChainPsetIterator
        (``Chain/ChainPsetIterator.h``)."""
        for row in self.get(burn_in=burn_in, thin=thin, flat=True):
            yield row

    def compact(self, burn_in=0, thin=1):
        """In-place burn+thin (≙ resetChainForSubSampling, Chain.h:269-305).

        Negative ``burn_in`` follows Python slice semantics (keep the last
        ``|burn_in|`` steps) on both backends.
        """
        thin = int(thin)
        if thin < 1:
            raise ValueError("thin must be >= 1")
        burn_in = int(burn_in)
        if burn_in < 0:
            burn_in = max(0, self.n_steps + burn_in)
        if self._native is not None:
            self._native.compact(burn_in, thin)
            self._cache = None
            self._logp_cache = None
            return
        kept = self._materialize()[burn_in::thin].copy()
        kept_logp = self._materialize_logp()[burn_in::thin].copy()
        self.clear()
        if kept.shape[0]:
            self._blocks = [kept]
            self._logp_blocks = [kept_logp]
            self._bytes = kept.shape[0] * self._row_bytes()
            self._cache = kept
            self._logp_cache = kept_logp
