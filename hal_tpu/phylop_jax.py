"""Device phyloP scoring — the Felsenstein LRT of hal_tpu.phylop compiled
to one XLA program per tree.

The reference delegates per-column likelihood fitting to phast
(reference phyloP/impl/halPhyloP.cpp:282-346: col_compute_log_likelihood
+ opt_newton_1d per column, one column at a time); hal_tpu.phylop
vectorizes that across unique column patterns in numpy.  This module
compiles the same fit: the pruning recursion is traced once over the
(small) model tree and the golden-section scale search runs as a
lax.fori_loop, so the whole alternative-model optimization for a window's
patterns is a single fused device program.

Layout: partial likelihoods live as (4, npat), so the per-edge transition
applications are two (4,4)@(4,npat) products in the rate matrix's
eigenbasis:
    P(t) @ L  =  U @ (exp(lam*t)[:,None] * (Uinv @ L))
with a per-pattern branch scale folded into t.  No per-pattern (4,4)
matrices are ever materialized.  Per-node renormalization (max over
states) keeps deep trees in range.

The fit runs in float64 on every platform, so its products never run in
reduced precision (no TF32 on GPU tensor cores) and it matches the
all-float64 numpy path to ~1e-12 in score units (PERF.md).

Division of labor: the device runs the expensive part — the golden-
section searches, ~100 full-tree likelihood evaluations per pattern —
and returns only the FITTED SCALES; the host then recomputes the final
null/alternative log-likelihoods once each in float64 (vectorized numpy,
2 evaluations) and applies the shared chi^2/sign/mask postprocessing
(hal_tpu.phylop.scores_from_lrt); the boundary columns of CON/ACC
(delta == 0 exactly, a point mass in the p-value mixture) keep their
exact zero.
"""

from __future__ import annotations

import functools

import numpy as np

from hal_tpu.phylop import SCALE_HI, SCALE_LO, NeutralModel, scores_from_lrt

_INVPHI = (np.sqrt(5.0) - 1.0) / 2.0
GOLDEN_ITERS = 50      # matches hal_tpu.phylop._fit_scale
SUBTREE_ITERS = 4      # matches hal_tpu.phylop._fit_subtree
MIN_PAD = 512


def _next_pow2(n: int) -> int:
    p = MIN_PAD
    while p < n:
        p <<= 1
    return p


class DevicePhyloP:
    """Jitted phyloP LRT over base-code patterns for one neutral model.

    Mirrors hal_tpu.phylop.score_patterns exactly (same golden-section
    iteration count, same per-mode scale bounds, same subtree alternating
    fit), in float64.
    """

    def __init__(self, model: NeutralModel, leaf_idx: dict,
                 mode: str = "CONACC",
                 sub_nodes: frozenset | None = None):
        import jax

        if mode not in ("CONACC", "CON", "ACC", "NNEUT"):
            raise ValueError("unknown phyloP mode " + mode)
        self.model = model
        self.leaf_idx = dict(leaf_idx)
        self.mode = mode
        self.sub_nodes = frozenset(sub_nodes or ())
        self.dtype = np.dtype(np.float64)
        # float64 math needs x64 (segmap_jax also sets this globally)
        jax.config.update("jax_enable_x64", True)
        # flatten the tree into a postorder edge program: for each internal
        # node, its children with (branch length, in-subtree flag)
        self._prog = []
        self._leaves = []
        for name in model.tree.postorder():
            kids = model.tree.children(name)
            if not kids:
                self._leaves.append(name)
                continue
            self._prog.append((name, [(c, float(model.branch_length[c]),
                                       c in self.sub_nodes) for c in kids]))
        self.nleaf = len(self._leaves)
        self._U = np.asarray(model._U, self.dtype)
        self._Uinv = np.asarray(model._Uinv, self.dtype)
        self._lam = np.asarray(model._lam, self.dtype)
        self._bg = np.asarray(model.background, self.dtype)
        self._jit_cache: dict = {}

    # ---- traced pieces -------------------------------------------------

    def _lnl(self, leafL, scale, sub_scale):
        """Log-likelihood per pattern.  leafL: dict name -> (4, npat);
        scale/sub_scale: (npat,) branch multipliers."""
        import jax.numpy as jnp

        U = jnp.asarray(self._U)
        Uinv = jnp.asarray(self._Uinv)
        lam = jnp.asarray(self._lam)
        bg = jnp.asarray(self._bg)
        tiny = jnp.asarray(1e-300, self.dtype)
        partial = dict(leafL)
        logscale = jnp.zeros(scale.shape, self.dtype)
        for name, kids in self._prog:
            L = None
            for child, bl, in_sub in kids:
                t = jnp.asarray(bl, self.dtype) * scale
                if in_sub:
                    t = t * sub_scale
                w = jnp.matmul(Uinv, partial.pop(child))  # (4, npat)
                w = w * jnp.exp(lam[:, None] * t[None, :])
                # P >= 0 (phylop.py pmatrix clip)
                w = jnp.maximum(jnp.matmul(U, w), 0.0)
                L = w if L is None else L * w
            mx = jnp.max(L, axis=0)
            mx = jnp.where(mx > 0, mx, 1.0)
            L = L / mx[None, :]
            logscale = logscale + jnp.log(mx)
            partial[name] = L
        root = partial[self._prog[-1][0]]
        return jnp.log(jnp.maximum(jnp.matmul(bg, root), tiny)) + logscale

    def _golden(self, fn, lo, hi, npat):
        """Vectorized golden-section maximization of fn over [lo, hi]
        (hal_tpu.phylop._fit_scale, GOLDEN_ITERS iterations)."""
        import jax
        import jax.numpy as jnp

        invphi = jnp.asarray(_INVPHI, self.dtype)
        a = jnp.full((npat,), lo, self.dtype)
        b = jnp.full((npat,), hi, self.dtype)

        def body(_, ab):
            a, b = ab
            c = b - invphi * (b - a)
            d = a + invphi * (b - a)
            left = fn(c) > fn(d)    # max in [a, d] -> drop (d, b]
            return jnp.where(left, a, c), jnp.where(left, d, b)

        a, b = jax.lax.fori_loop(0, GOLDEN_ITERS, body, (a, b))
        s = (a + b) / 2
        return s, fn(s)

    def _alt_bounds(self):
        lo, hi = SCALE_LO, SCALE_HI
        if self.mode == "CON":
            hi = 1.0
        elif self.mode == "ACC":
            lo = 1.0
        return lo, hi

    def _build_jit(self, npat):
        import jax
        import jax.numpy as jnp

        def kernel(codes):  # (nleaf, npat) int32 base codes, 4 = missing
            states = jnp.arange(4, dtype=jnp.int32)[:, None]
            leafL = {name: jnp.where((codes[i][None, :] == states)
                                     | (codes[i][None, :] >= 4),
                                     jnp.asarray(1.0, self.dtype),
                                     jnp.asarray(0.0, self.dtype))
                     for i, name in enumerate(self._leaves)}
            ones = jnp.ones((npat,), self.dtype)
            lo, hi = self._alt_bounds()
            if not self.sub_nodes:
                scale, _ = self._golden(
                    lambda s: self._lnl(leafL, s, ones), lo, hi, npat)
                return ones, scale, ones
            # subtree LRT: null fits the whole-tree scale alone; the
            # alternative alternates (scale, subtree-scale) 1-D fits
            null_scale, _ = self._golden(
                lambda s: self._lnl(leafL, s, ones), SCALE_LO, SCALE_HI,
                npat)
            scale, sub = ones, ones

            def outer(_, ss):
                scale, sub = ss
                scale, _ = self._golden(
                    lambda s: self._lnl(leafL, s, sub), SCALE_LO, SCALE_HI,
                    npat)
                sub, _ = self._golden(
                    lambda s: self._lnl(leafL, scale, s), lo, hi, npat)
                return scale, sub

            scale, sub = jax.lax.fori_loop(0, SUBTREE_ITERS, outer,
                                           (scale, sub))
            return null_scale, scale, sub

        return jax.jit(kernel)

    # ---- public --------------------------------------------------------

    def fit(self, patterns: np.ndarray):
        """(null_scale, scale, sub_scale) fitted per pattern — patterns
        (npat, nleaf) with columns ordered by leaf_idx.  Pads to a pow2
        bucket so the compile is reused across windows."""
        npat = patterns.shape[0]
        pad = _next_pow2(npat)
        codes = np.full((self.nleaf, pad), 4, np.int32)
        cols = [self.leaf_idx[n] for n in self._leaves]
        codes[:, :npat] = patterns[:, cols].T
        fn = self._jit_cache.get(pad)
        if fn is None:
            fn = self._jit_cache[pad] = self._build_jit(pad)
        null_scale, scale, sub = fn(codes)
        return (np.asarray(null_scale, np.float64)[:npat],
                np.asarray(scale, np.float64)[:npat],
                np.asarray(sub, np.float64)[:npat])

    def score_patterns(self, patterns: np.ndarray) -> np.ndarray:
        """Drop-in for hal_tpu.phylop.score_patterns: device golden
        search, then two float64 host likelihood evaluations at the
        fitted scales + the shared p-value/sign postprocessing."""
        from hal_tpu.phylop import column_log_likelihood

        npat = patterns.shape[0]
        if npat == 0:
            return np.zeros(0)
        null_scale, scale, sub = self.fit(patterns)
        if self.sub_nodes:
            null_lnl = column_log_likelihood(self.model, self.leaf_idx,
                                             patterns, null_scale)
            alt_lnl = column_log_likelihood(self.model, self.leaf_idx,
                                            patterns, scale,
                                            self.sub_nodes, sub)
            sign_scale = sub
        else:
            null_lnl = column_log_likelihood(self.model, self.leaf_idx,
                                             patterns, np.ones(npat))
            alt_lnl = column_log_likelihood(self.model, self.leaf_idx,
                                            patterns, scale)
            sign_scale = scale
        delta = alt_lnl - null_lnl
        if self.sub_nodes:
            inside = [self.leaf_idx[n] for n in self.leaf_idx
                      if n in self.sub_nodes]
            outside = [self.leaf_idx[n] for n in self.leaf_idx
                       if n not in self.sub_nodes]
            informative = ((patterns[:, inside] < 4).any(axis=1)
                           & (patterns[:, outside] < 4).any(axis=1))
        else:
            informative = (patterns < 4).sum(axis=1) > 0
        return scores_from_lrt(delta, sign_scale, informative, self.mode)


@functools.lru_cache(maxsize=None)
def on_accelerator() -> bool:
    """True when jax's default backend is a real accelerator (the
    PhyloPScorer "auto" policy compiles the fit only then)."""
    import jax

    return jax.default_backend() != "cpu"
