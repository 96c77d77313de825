"""NeuTra: normalizing-flow-preconditioned gradient sampling.

Hoffman et al. (2019) "NeuTra-lizing Bad Geometry in HMC Using Neural
Transport": fit a RealNVP flow f to the target by reverse-KL (ELBO
maximization — the flow generalization of ADVI), then sample the
PULLED-BACK target

    logp_z(z) = logp(f(z)) + log|det df/dz|

with any gradient sampler; pushing the draws through f returns exact
posterior samples (the flow only preconditions, it does not bias).
Funnels and banana ridges that defeat a diagonal mass matrix become
near-isotropic in z-space.

Everything is pure JAX: the flow is a pytree of MLP parameters, training
is one jitted Adam scan (batched matmuls), and the warped logp is
traceable so NUTS/ChEES/HMC work unchanged. No reference counterpart
(gradient-free C++ library) — north-star scope.
"""

from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp


# -- tiny MLP ----------------------------------------------------------------


def _mlp_init(key, sizes, dtype):
    params = []
    for i, (a, b) in enumerate(zip(sizes[:-1], sizes[1:])):
        k = jax.random.fold_in(key, i)
        w = jax.random.normal(k, (a, b), dtype) * jnp.sqrt(2.0 / a)
        params.append((w, jnp.zeros((b,), dtype)))
    # zero-init the last layer: the flow starts as the identity map
    w, b = params[-1]
    params[-1] = (jnp.zeros_like(w), b)
    return params


def _mlp_apply(params, x):
    for w, b in params[:-1]:
        x = jnp.tanh(x @ w + b)
    w, b = params[-1]
    return x @ w + b


# -- RealNVP -----------------------------------------------------------------


class RealNVP:
    """Stack of affine coupling layers with alternating even/odd masks.

    ``forward(params, z) -> (x, logdet)`` maps base noise to target space;
    ``inverse`` is exact. Conditioner: one hidden-layer MLP per coupling,
    outputting (shift, log_scale) with tanh-bounded log_scale (|ls| <=
    ``scale_cap``) for stable training.
    """

    def __init__(self, dim, n_layers=6, hidden=64, scale_cap=4.0,
                 dtype=jnp.float32):
        if dim < 2:
            raise ValueError("RealNVP needs dim >= 2 (use ADVI for 1-D)")
        self.dim = int(dim)
        self.n_layers = int(n_layers)
        self.hidden = int(hidden)
        self.scale_cap = float(scale_cap)
        self.dtype = dtype
        idx = np.arange(self.dim)
        self._masks = [(idx % 2) == (layer % 2) for layer in
                       range(self.n_layers)]

    def init(self, key):
        params = []
        for layer, mask in enumerate(self._masks):
            n_in, n_out = int(mask.sum()), int((~mask).sum())
            params.append(_mlp_init(
                jax.random.fold_in(key, layer),
                (n_in, self.hidden, 2 * n_out), self.dtype,
            ))
        return params

    def _shift_scale(self, layer_params, a, n_out):
        out = _mlp_apply(layer_params, a)
        shift, raw = out[..., :n_out], out[..., n_out:]
        log_scale = self.scale_cap * jnp.tanh(raw / self.scale_cap)
        return shift, log_scale

    def forward(self, params, z):
        """(P,) base draw -> (x, logdet)."""
        x = z
        logdet = jnp.zeros((), z.dtype)
        for layer_params, mask in zip(params, self._masks):
            a, b = x[mask], x[~mask]
            shift, ls = self._shift_scale(layer_params, a, b.shape[-1])
            b = b * jnp.exp(ls) + shift
            x = jnp.zeros_like(x).at[mask].set(a).at[~mask].set(b)
            logdet = logdet + jnp.sum(ls)
        return x, logdet

    def inverse(self, params, x):
        """(P,) target point -> (z, logdet of dz/dx)."""
        z = x
        logdet = jnp.zeros((), x.dtype)
        for layer_params, mask in zip(reversed(params),
                                      reversed(self._masks)):
            a, b = z[mask], z[~mask]
            shift, ls = self._shift_scale(layer_params, a, b.shape[-1])
            b = (b - shift) * jnp.exp(-ls)
            z = jnp.zeros_like(z).at[mask].set(a).at[~mask].set(b)
            logdet = logdet - jnp.sum(ls)
        return z, logdet


# -- IAF ---------------------------------------------------------------------


class IAF:
    """Inverse autoregressive flow (Kingma et al. 2016) with MADE masking.

    x_i = z_i·exp(ls_i(z_{<i})) + shift_i(z_{<i}): the SAMPLING direction
    (base → target) is one masked-matmul pass — fully parallel, matmul-shaped —
    which is exactly the direction NeuTra uses for training, the warped
    logp, and transport. ``inverse`` (density of an external point) is the
    sequential direction and runs a dim-length ``fori_loop``; it exists for
    completeness but no NeuTra path needs it.

    Layers are stacked with input reversal in between so every coordinate
    conditions on every other within two layers. Conditioner: one-hidden-
    layer MADE (Germain et al. 2015) per flow layer, zero-initialized last
    layer → the flow starts at the identity. Same interface as
    :class:`RealNVP` (init/forward/inverse), so ``NeuTra(..., flow=IAF(P))``
    is a drop-in swap.
    """

    def __init__(self, dim, n_layers=4, hidden=64, scale_cap=4.0,
                 dtype=jnp.float32):
        if dim < 2:
            raise ValueError("IAF needs dim >= 2 (use ADVI for 1-D)")
        self.dim = int(dim)
        self.n_layers = int(n_layers)
        self.hidden = max(int(hidden), self.dim)
        self.scale_cap = float(scale_cap)
        self.dtype = dtype
        # MADE degrees: inputs 1..D; hidden cycles 1..D-1; outputs produce
        # (shift_j, ls_j) conditioned on strictly-lower-degree inputs
        d_in = np.arange(1, self.dim + 1)
        d_hid = (np.arange(self.hidden) % max(self.dim - 1, 1)) + 1
        self._mask_in = jnp.asarray(
            (d_hid[None, :] >= d_in[:, None]).astype(np.float32)
        )  # (D, H): hidden k sees input i iff m_k >= d_i
        out_deg = np.concatenate([d_in, d_in])  # (2D,) shift then ls
        self._mask_out = jnp.asarray(
            (out_deg[None, :] > d_hid[:, None]).astype(np.float32)
        )  # (H, 2D): output j sees hidden k iff d_j > m_k

    def init(self, key):
        params = []
        for layer in range(self.n_layers):
            k1, k2 = jax.random.split(jax.random.fold_in(key, layer))
            w1 = jax.random.normal(
                k1, (self.dim, self.hidden), self.dtype
            ) * jnp.sqrt(2.0 / self.dim)
            b1 = jnp.zeros((self.hidden,), self.dtype)
            # zero-init output layer: identity flow at start
            w2 = jnp.zeros((self.hidden, 2 * self.dim), self.dtype)
            b2 = jnp.zeros((2 * self.dim,), self.dtype)
            params.append((w1, b1, w2, b2))
        return params

    def _shift_ls(self, layer_params, z):
        w1, b1, w2, b2 = layer_params
        h = jnp.tanh(z @ (w1 * self._mask_in) + b1)
        out = h @ (w2 * self._mask_out) + b2
        shift, raw = out[..., : self.dim], out[..., self.dim:]
        return shift, self.scale_cap * jnp.tanh(raw / self.scale_cap)

    def forward(self, params, z):
        """(P,) base draw -> (x, logdet); one parallel pass per layer."""
        x = z
        logdet = jnp.zeros((), z.dtype)
        for layer_params in params:
            shift, ls = self._shift_ls(layer_params, x)
            x = x * jnp.exp(ls) + shift
            logdet = logdet + jnp.sum(ls)
            x = x[::-1]  # permute so later layers condition the other way
        return x, logdet

    def inverse(self, params, x):
        """(P,) target point -> (z, logdet of dz/dx); sequential in dim."""
        z = x
        logdet = jnp.zeros((), x.dtype)
        for layer_params in reversed(params):
            z = z[::-1]  # undo the layer's output permutation

            def solve_coord(i, zi):
                # z_i depends on z_{<i} only, so filling coordinates in
                # ascending order converges exactly in one sweep
                shift, ls = self._shift_ls(layer_params, zi)
                val = (z[i] - shift[i]) * jnp.exp(-ls[i])
                return zi.at[i].set(val)

            zi = jax.lax.fori_loop(0, self.dim, solve_coord,
                                   jnp.zeros_like(z))
            _, ls = self._shift_ls(layer_params, zi)
            logdet = logdet - jnp.sum(ls)
            z = zi
        return z, logdet


# -- rational-quadratic spline coupling (neural spline flow) -----------------


def _rq_spline(x, widths, heights, derivs, inverse=False):
    """Monotone rational-quadratic spline (Gregory & Delbourgo 1982, as
    used by Durkan et al. 2019 "Neural Spline Flows").

    ``x``: (..., D) inputs. ``widths``/``heights``: (..., D, K) positive
    bin sizes summing to 2B per coordinate; ``derivs``: (..., D, K+1)
    positive knot derivatives with the boundary entries == 1 so the spline
    meets the identity tails C¹-continuously. Outside [-B, B] the map is
    the identity. Returns ``(y, log|dy/dx|)`` elementwise — both
    directions closed-form (the inverse solves one quadratic per point),
    so unlike IAF there is no sequential direction.
    """
    xk = jnp.cumsum(widths, axis=-1)
    bound = xk[..., -1:] / 2.0
    xk = jnp.concatenate([jnp.zeros_like(xk[..., :1]), xk], axis=-1) - bound
    yk = jnp.cumsum(heights, axis=-1)
    yk = jnp.concatenate([jnp.zeros_like(yk[..., :1]), yk], axis=-1) - bound

    b = bound[..., 0]
    inside = (x > -b) & (x < b)
    # clamp so the bin arithmetic below is well-defined; result is
    # discarded via `inside`
    xs = jnp.clip(x, -b * (1 - 1e-6), b * (1 - 1e-6))

    knots = yk if inverse else xk
    k = jnp.sum(xs[..., None] >= knots[..., :-1], axis=-1) - 1
    k = jnp.clip(k, 0, widths.shape[-1] - 1)

    take = lambda a: jnp.take_along_axis(a, k[..., None], axis=-1)[..., 0]
    x0, w = take(xk), take(widths)
    y0, h = take(yk), take(heights)
    d0, d1 = take(derivs[..., :-1]), take(derivs[..., 1:])
    s = h / w  # bin slope

    if not inverse:
        xi = (xs - x0) / w
        omx = 1.0 - xi
        denom = s + (d1 + d0 - 2.0 * s) * xi * omx
        y = y0 + h * (s * xi * xi + d0 * xi * omx) / denom
        deriv = (s * s * (d1 * xi * xi + 2.0 * s * xi * omx
                          + d0 * omx * omx)) / (denom * denom)
        out = jnp.where(inside, y, x)
        ld = jnp.where(inside, jnp.log(deriv), 0.0)
        return out, ld

    dy = xs - y0
    a_ = h * (s - d0) + dy * (d1 + d0 - 2.0 * s)
    b_ = h * d0 - dy * (d1 + d0 - 2.0 * s)
    c_ = -s * dy
    disc = jnp.maximum(b_ * b_ - 4.0 * a_ * c_, 0.0)
    xi = 2.0 * c_ / (-b_ - jnp.sqrt(disc))
    xi = jnp.clip(xi, 0.0, 1.0)
    omx = 1.0 - xi
    denom = s + (d1 + d0 - 2.0 * s) * xi * omx
    deriv = (s * s * (d1 * xi * xi + 2.0 * s * xi * omx
                      + d0 * omx * omx)) / (denom * denom)
    out = jnp.where(inside, x0 + xi * w, x)
    ld = jnp.where(inside, -jnp.log(deriv), 0.0)
    return out, ld


class SplineCoupling:
    """Neural spline flow: RealNVP's coupling split with the affine map
    replaced by a K-bin monotone rational-quadratic spline on [-B, B]
    (identity tails). Strictly more expressive per layer than affine
    coupling, and — unlike :class:`IAF` — the inverse is also one parallel
    pass. A learnable per-dimension affine head follows the spline stack:
    the spline maps the [-B, B] box to itself, so without the head the
    flow could never push mass past the bound (a N(0, 2²) marginal would
    be unreachable). Zero-initialized conditioner + head → exact identity
    at start. Same init/forward/inverse interface as :class:`RealNVP`,
    so ``NeuTra(..., flow=SplineCoupling(P))`` drops in.
    """

    def __init__(self, dim, n_layers=4, hidden=64, n_bins=8, bound=5.0,
                 dtype=jnp.float32):
        if dim < 2:
            raise ValueError("SplineCoupling needs dim >= 2 (use ADVI "
                             "for 1-D)")
        self.dim = int(dim)
        self.n_layers = int(n_layers)
        self.hidden = int(hidden)
        self.n_bins = int(n_bins)
        self.bound = float(bound)
        self.dtype = dtype
        idx = np.arange(self.dim)
        self._masks = [(idx % 2) == (layer % 2) for layer in
                       range(self.n_layers)]
        # eps + softplus(c0) == 1 → zero raw params give EXACTLY unit
        # derivatives (identity at init) while keeping the eps floor
        self._deriv_eps = 1e-3
        self._c0 = float(np.log(np.expm1(1.0 - self._deriv_eps)))

    def init(self, key):
        params = []
        per = 3 * self.n_bins - 1  # K widths + K heights + K-1 inner derivs
        for layer, mask in enumerate(self._masks):
            n_in, n_out = int(mask.sum()), int((~mask).sum())
            params.append(_mlp_init(
                jax.random.fold_in(key, layer),
                (n_in, self.hidden, per * n_out), self.dtype,
            ))
        # affine head: (shift, log_scale), zero-init → identity
        params.append((jnp.zeros((self.dim,), self.dtype),
                       jnp.zeros((self.dim,), self.dtype)))
        return params

    def _spline_params(self, layer_params, a, n_out):
        K = self.n_bins
        theta = _mlp_apply(layer_params, a).reshape(
            a.shape[:-1] + (n_out, 3 * K - 1)
        )
        eps = 1e-3  # floor keeps bins/derivatives away from collapse
        widths = jax.nn.softmax(theta[..., :K], axis=-1)
        widths = (eps + (1.0 - eps * K) * widths) * (2.0 * self.bound)
        heights = jax.nn.softmax(theta[..., K:2 * K], axis=-1)
        heights = (eps + (1.0 - eps * K) * heights) * (2.0 * self.bound)
        inner = jax.nn.softplus(theta[..., 2 * K:] + self._c0) + self._deriv_eps
        ones = jnp.ones_like(inner[..., :1])
        derivs = jnp.concatenate([ones, inner, ones], axis=-1)
        return widths, heights, derivs

    def _apply(self, params, v, inverse):
        shift, ls = params[-1]
        layers = list(zip(params[:-1], self._masks))
        logdet = jnp.zeros((), v.dtype)
        if inverse:
            layers = layers[::-1]
            v = (v - shift) * jnp.exp(-ls)
            logdet = logdet - jnp.sum(ls)
        for layer_params, mask in layers:
            a, b = v[mask], v[~mask]
            w, h, d = self._spline_params(layer_params, a, b.shape[-1])
            b, ld = _rq_spline(b, w, h, d, inverse=inverse)
            v = jnp.zeros_like(v).at[mask].set(a).at[~mask].set(b)
            logdet = logdet + jnp.sum(ld)
        if not inverse:
            v = v * jnp.exp(ls) + shift
            logdet = logdet + jnp.sum(ls)
        return v, logdet

    def forward(self, params, z):
        """(P,) base draw -> (x, logdet)."""
        return self._apply(params, z, inverse=False)

    def inverse(self, params, x):
        """(P,) target point -> (z, logdet of dz/dx); also one parallel
        pass (quadratic-formula bin inversion)."""
        return self._apply(params, x, inverse=True)


# -- NeuTra ------------------------------------------------------------------


class FitResult(NamedTuple):
    elbo_history: np.ndarray
    final_elbo: float


class NeuTra:
    """Fit a flow to ``logp_fn`` and expose the warped target + transport.

    Typical use::

        nt = NeuTra(logp, dim).fit(2000)
        s = nt.make_sampler(NUTSSampler, n_chains=32)
        s.warmup(500); s.run(2000)
        x = nt.transform(s.get_samples(flat=True))   # posterior draws
    """

    def __init__(self, logp_fn, dim, flow=None, seed=0, dtype=jnp.float32,
                 mesh=None):
        """``mesh``: optional ``jax.sharding.Mesh``. Shards the flow-
        training ELBO/MLE batch axis over the mesh (flow params + Adam
        state replicated; the batch-mean gradient reduction lowers to a
        psum) and is forwarded to :meth:`make_sampler` so the warped
        chains shard the same way."""
        self.logp_fn = logp_fn
        self.dim = int(dim)
        self.flow = flow if flow is not None else RealNVP(self.dim,
                                                          dtype=dtype)
        self.dtype = dtype
        self.mesh = mesh
        self._batch_sharding = None
        if mesh is not None:
            from mcmcpp_tpu.parallel.mesh import walker_sharding

            self._batch_sharding = walker_sharding(mesh)
        self._key = jax.random.key(seed)
        self._key, init_key = jax.random.split(self._key)
        self.params = self.flow.init(init_key)
        # last optimizer state (fit / refit_forward_kl) — persisted by
        # io/checkpoint.py kind="neutra" so an interrupted fit resumes
        # with warm Adam moments instead of refitting from scratch
        self._opt_state = None
        self.fit_result = None
        self.refit_result = None

    # -- training (reverse KL / ELBO ascent) --------------------------------

    def _elbo(self, params, key, batch):
        z = jax.random.normal(key, (batch, self.dim), self.dtype)
        if self._batch_sharding is not None:
            z = jax.lax.with_sharding_constraint(z, self._batch_sharding)

        def one(zi):
            x, logdet = self.flow.forward(params, zi)
            return self.logp_fn(x) + logdet

        # base entropy is constant in params; dropped from the objective
        return jnp.mean(jax.vmap(one)(z))

    def fit(self, n_steps=2000, batch=128, learning_rate=1e-3,
            resume=False):
        """Adam ascent on the ELBO as one jitted scan. Returns self;
        the trace is in ``self.fit_result``.

        ``resume=True`` continues from the retained optimizer moments
        (``self._opt_state`` — survives checkpoint/restore), so a
        segmented ``fit(k); fit(k, resume=True)`` optimizes identically
        to the same total budget with a save/load in between.
        """
        import optax

        opt = optax.adam(learning_rate)

        def step(carry, key):
            params, opt_state = carry
            loss, grads = jax.value_and_grad(
                lambda p: -self._elbo(p, key, int(batch))
            )(params)
            updates, opt_state = opt.update(grads, opt_state)
            params = optax.apply_updates(params, updates)
            return (params, opt_state), -loss

        self._key, fit_key = jax.random.split(self._key)
        keys = jax.random.split(fit_key, int(n_steps))
        opt0 = (self._opt_state if resume and self._opt_state is not None
                else opt.init(self.params))
        (params, opt_state), elbos = jax.jit(
            lambda carry, ks: jax.lax.scan(step, carry, ks)
        )((self.params, opt0), keys)
        self.params = jax.block_until_ready(params)
        self._opt_state = opt_state
        hist = np.asarray(elbos)
        self.fit_result = FitResult(hist, float(hist[-100:].mean()))
        return self

    def refit_forward_kl(self, samples, n_steps=1000, batch=256,
                         learning_rate=1e-3):
        """Refine the flow by maximum likelihood on posterior draws
        (forward KL) — the complement of :meth:`fit`'s reverse KL:
        mass-covering instead of mode-seeking, and it needs no logp
        gradients, only draws. Closes the per-chain-refinement loop::

            nt.fit(2000)                      # reverse-KL warm start
            s = nt.make_sampler(NUTSSampler, 32); s.warmup(500); s.run(2000)
            nt.refit_forward_kl(nt.transform(s.get_samples(flat=True)))
            s2 = nt.make_sampler(NUTSSampler, 32)   # sharper transport

        Maximizes ``E_x[log q(x)]`` with ``log q(x) = log N(f⁻¹(x); 0, I)
        + log|det df⁻¹/dx|`` via the flow's exact inverse (one parallel
        pass for RealNVP/SplineCoupling; sequential for IAF). Returns
        self; trace in ``self.refit_result`` (mean log q history).
        Previously built samplers keep the OLD params (warped_logp closes
        over them) — build a fresh one after refitting.
        """
        import optax

        x = jnp.asarray(samples, self.dtype)
        if x.ndim != 2 or x.shape[1] != self.dim:
            raise ValueError(f"samples must be (N, {self.dim}), got "
                             f"{tuple(x.shape)}")
        n = x.shape[0]
        batch = int(min(batch, n))
        const = -0.5 * self.dim * np.log(2.0 * np.pi)

        def logq(params, xi):
            z, ld = self.flow.inverse(params, xi)
            return const - 0.5 * jnp.sum(z * z) + ld

        opt = optax.adam(learning_rate)

        def step(carry, key):
            params, opt_state = carry
            idx = jax.random.randint(key, (batch,), 0, n)
            xb = x[idx]
            if self._batch_sharding is not None:
                xb = jax.lax.with_sharding_constraint(
                    xb, self._batch_sharding
                )
            obj, grads = jax.value_and_grad(
                lambda p: jnp.mean(jax.vmap(lambda xi: logq(p, xi))(xb))
            )(params)
            updates, opt_state = opt.update(jax.tree.map(lambda g: -g, grads),
                                            opt_state)
            params = optax.apply_updates(params, updates)
            return (params, opt_state), obj

        self._key, fit_key = jax.random.split(self._key)
        keys = jax.random.split(fit_key, int(n_steps))
        (params, opt_state), hist = jax.jit(
            lambda carry, ks: jax.lax.scan(step, carry, ks)
        )((self.params, opt.init(self.params)), keys)
        self.params = jax.block_until_ready(params)
        self._opt_state = opt_state
        hist = np.asarray(hist)
        self.refit_result = FitResult(hist, float(hist[-100:].mean()))
        return self

    # -- the warped target ---------------------------------------------------

    def warped_logp(self):
        """z-space logp for any gradient sampler (closure over the fitted
        params — refit invalidates previously built samplers)."""
        params = self.params
        flow = self.flow
        logp = self.logp_fn

        def logp_z(z):
            x, logdet = flow.forward(params, z)
            return logp(x) + logdet

        return logp_z

    def make_sampler(self, sampler_cls, n_chains, seed=1, **kw):
        """Build ``sampler_cls`` on the warped target, initialized from
        base noise (the flow's own approximate posterior). A ``mesh``
        given at construction is forwarded so the warped chain batch
        shards over it (override by passing ``mesh=`` explicitly)."""
        if self.mesh is not None:
            kw.setdefault("mesh", self.mesh)
        s = sampler_cls(self.warped_logp(), n_chains=n_chains,
                        n_params=self.dim, seed=seed, **kw)
        self._key, k = jax.random.split(self._key)
        z0 = jax.random.normal(k, (int(n_chains), self.dim), self.dtype)
        s.init(np.asarray(z0))
        return s

    def transform(self, z_draws):
        """(N, P) z-space draws -> (N, P) posterior draws."""
        arr = jnp.asarray(z_draws, self.dtype)
        x, _ = jax.jit(jax.vmap(
            lambda zi: self.flow.forward(self.params, zi)
        ))(jnp.atleast_2d(arr))
        return np.asarray(x)

    def sample_approximate(self, key, n):
        """(n, P) draws from the flow itself (VI-quality, no MCMC)."""
        z = jax.random.normal(key, (int(n), self.dim), self.dtype)
        return self.transform(z)
