"""Abstract linear operators for the QP Hessian ``A``.

The reference passes ``A`` as a dense numpy array and calls ``A.dot(x)`` in
every solver hot loop (e.g. ``CCQPpy/src/ccqppy/solvers.py:938``).
Here ``A`` is abstracted behind a small operator protocol so the *same* solver
code serves:

* the 3x3 README problem (``DenseOperator``),
* batched Wishart ensembles (``DenseOperator`` under ``vmap``),
* block-sparse contact-mechanics Hessians (``BlockSparseOperator``, ELL
  layout, batched small block products),
* a single huge QP row-sharded over a device mesh (``ShardedDenseOperator``
  inside ``shard_map`` — matvec via all-gather + local GEMM, dot products via
  ``psum`` partial reductions).

Operators also own the *inner product* (``dot``) so distributed solvers get
collective-reduced dot products without touching solver code.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

# Exact matvecs request HIGHEST precision: at DEFAULT precision XLA may
# multiply f32 operands in a reduced-precision format (TF32 on recent NVIDIA
# cards), which would poison gradients near convergence.  ``FastDense``
# exposes the DEFAULT sweep for the residual-replacement ladder; operators
# whose results feed convergence decisions keep HIGHEST.
_PRECISION = lax.Precision.HIGHEST

from ccqppy_jax.utils.pytree import register_pytree_dataclass



def _gemv_fence(y):
    """Post-GEMV optimization barrier between a dense GEMV and its
    consumers.

    It keeps XLA from fusing the solver's follow-up reductions (p.Ap, r.r)
    into the GEMV.  The barrier is semantically the identity; the only
    fusion it forfeits is the GEMV epilogue of a small elementwise
    consumer.  Applied by every dense-family operator so all solvers
    share it.  Whether it pays on the GPU backend is not measured yet:
    time the dense cells with and without it before keeping it.
    """
    return lax.optimization_barrier(y)

class LinearOperator:
    """Protocol: symmetric positive (semi)definite linear operator."""

    def matvec(self, x):
        raise NotImplementedError

    def dot(self, u, v):
        """Inner product consistent with the operator's data distribution."""
        return jnp.vdot(u, v)

    def norm(self, u):
        return jnp.sqrt(self.dot(u, u))

    def inf_norm(self):
        """||A||_inf — used for MPRGP-BB's fixed expansion step 2/||A||_inf
        (docs solvers.html MPRGPBB: ``alpha_bar = 2/np.linalg.norm(A, np.inf)``)."""
        raise NotImplementedError

    def global_size(self, x):
        """Logical problem dimension n given an iterate (shard)."""
        return x.shape[-1]

    def reduce_min(self, v):
        """Global min of a per-shard scalar (identity off-mesh)."""
        return v

    def diagonal(self):
        """diag(A), used for Jacobi preconditioning."""
        raise NotImplementedError

    def matvec_exact(self, x):
        """Full-precision matvec.  Defaults to ``matvec``; mixed-precision
        operators (``MixedPrecDense``) override ``matvec`` with a cheap
        low-precision sweep and keep the exact product here — used by the
        residual-replacement refreshes of ``models.pcg``."""
        return self.matvec(x)

    def spectral_bounds(self):
        """(L, mu) with L >= lambda_max(A) and 0 < mu <= lambda_min(A).

        Consumed by the strong-convexity accelerated solver
        (``models.apgd.solve_sc``), whose optimal constant momentum needs
        both ends of the spectrum.  Default: a valid L (``||A||_inf``, an
        upper bound on ``||A||_2`` for symmetric A) and ``None`` for mu —
        solve_sc raises at trace time when mu is unavailable.  Wrap the
        operator in ``SpectralDense`` (or use ``estimate_spectral_bounds``)
        to supply real bounds."""
        return self.inf_norm(), None


@register_pytree_dataclass
class DenseOperator(LinearOperator):
    """Dense symmetric matrix.  matvec lowers to a single XLA GEMV.

    ``A`` may carry a leading batch axis under ``vmap``; all methods are
    written batch-free and rely on vmap for batching.
    """

    A: jax.Array

    def matvec(self, x):
        return _gemv_fence(jnp.dot(self.A, x, preferred_element_type=x.dtype,
                                   precision=_PRECISION))

    def inf_norm(self):
        return jnp.max(jnp.sum(jnp.abs(self.A), axis=-1))

    def diagonal(self):
        return jnp.diagonal(self.A)


@register_pytree_dataclass
class FastDense(LinearOperator):
    """Dense operator with a DEFAULT-precision cheap sweep and a HIGHEST
    exact sweep over the SAME f32 buffer — zero extra memory.

    Error model, measured on an NVIDIA H100 80GB HBM3 (700 W power limit;
    B=2048, n=1000 conditioned Wishart, f32): XLA lowers the batched
    matrix-VECTOR product without tensor cores, so ``DEFAULT`` keeps
    f32-grade products — max relative error 1.8e-7 against float64,
    identical to ``HIGHEST`` — at the same speed (2.81 vs 2.82 ms/sweep,
    ~2.9 TB/s).  A matrix-MATRIX product at ``DEFAULT`` does run in TF32
    on this card (3.6e-4 relative at n=1000), so the cheap sweep's error
    bound is TF32's if a caller ever batches several right-hand sides
    into one product: ~2^-11 relative per product, ~4e-4 on these
    matrices.  On this card the split buys nothing for GEMVs; it is kept
    for the residual-replacement contract below.

    Use exactly like ``MixedPrecDense``: the residual-replacement PCG
    (``models.pcg`` with ``refresh_every > 0``) rides ``matvec`` in cheap
    segments and anchors truth at ``matvec_exact`` refreshes; every
    reported residual comes from the exact sweep.  Do NOT use with plain
    (non-rr) solvers whose in-loop gradients assume a trustworthy operator.
    """

    A: jax.Array

    def matvec(self, x):
        return _gemv_fence(jnp.dot(self.A, x, preferred_element_type=x.dtype))

    def matvec_exact(self, x):
        return _gemv_fence(jnp.dot(self.A, x, preferred_element_type=x.dtype,
                                   precision=_PRECISION))

    def inf_norm(self):
        return jnp.max(jnp.sum(jnp.abs(self.A), axis=-1))

    def diagonal(self):
        return jnp.diagonal(self.A)


@register_pytree_dataclass(meta_fields=("n",))
class BlockSparseOperator(LinearOperator):
    """Block-sparse (BSR/ELL hybrid) symmetric operator.

    Static ELL layout: every block-row holds exactly ``k_max`` dense
    ``bs x bs`` blocks (padded with zero blocks / self-pointing columns), so
    the matvec is a fully static gather + batched small GEMM that XLA maps to
    the matrix units.  Shapes:

        blocks:   (n_block_rows, k_max, bs, bs)
        cols:     (n_block_rows, k_max)  int32 block-column ids
        n:        logical dimension (n_block_rows * bs)

    Build from scipy-style BSR via ``from_bsr``.
    """

    blocks: jax.Array
    cols: jax.Array
    n: int

    @staticmethod
    def from_dense_blocks(blocks, cols):
        nbr, kmax, bs, _ = blocks.shape
        return BlockSparseOperator(blocks, cols.astype(jnp.int32), int(nbr * bs))

    @staticmethod
    def from_scipy_bsr(mat, dtype=jnp.float32):
        """Build from a ``scipy.sparse.bsr_matrix`` (or any matrix
        convertible to one).  Rows are padded to the max blocks-per-row with
        zero blocks pointing at block-column 0 (a zero block contributes
        nothing, so any column id is safe)."""
        import numpy as np
        import scipy.sparse as sp

        bsr = mat if sp.issparse(mat) and mat.format == "bsr" else \
            sp.bsr_matrix(mat)
        bs = bsr.blocksize[0]
        if bsr.blocksize[0] != bsr.blocksize[1]:
            raise ValueError("square blocks required")
        nbr = bsr.shape[0] // bs
        counts = np.diff(bsr.indptr)
        kmax = max(int(counts.max()), 1)
        blocks = np.zeros((nbr, kmax, bs, bs), np.asarray(bsr.data).dtype)
        cols = np.zeros((nbr, kmax), np.int32)
        for r in range(nbr):
            lo, hi = bsr.indptr[r], bsr.indptr[r + 1]
            k = hi - lo
            blocks[r, :k] = bsr.data[lo:hi]
            cols[r, :k] = bsr.indices[lo:hi]
        return BlockSparseOperator(jnp.asarray(blocks, dtype),
                                   jnp.asarray(cols), int(nbr * bs))

    def matvec(self, x):
        nbr, kmax, bs, _ = self.blocks.shape
        xb = x.reshape(nbr, bs)
        gathered = xb[self.cols]                      # (nbr, kmax, bs)
        # (nbr, kmax, bs, bs) @ (nbr, kmax, bs) -> (nbr, kmax, bs)
        prod = jnp.einsum("rkij,rkj->rki", self.blocks, gathered,
                          preferred_element_type=x.dtype,
                          precision=_PRECISION)
        return jnp.sum(prod, axis=1).reshape(self.n)

    def inf_norm(self):
        nbr, kmax, bs, _ = self.blocks.shape
        rowsum = jnp.sum(jnp.abs(self.blocks), axis=(1, 3))  # (nbr, bs)
        return jnp.max(rowsum)

    def diagonal(self):
        nbr, kmax, bs, _ = self.blocks.shape
        row_ids = jnp.arange(nbr, dtype=self.cols.dtype)[:, None]
        on_diag = self.cols == row_ids                       # (nbr, kmax)
        diag_blocks = jnp.einsum("rkij,rk->rij", self.blocks,
                                 on_diag.astype(self.blocks.dtype),
                                 precision=_PRECISION)
        return jnp.diagonal(diag_blocks, axis1=-2, axis2=-1).reshape(self.n)


@register_pytree_dataclass
class CastDense(LinearOperator):
    """Dense operator stored in a low-precision dtype (bfloat16), computed
    against a low-precision cast of the operand with float32 accumulation.

    This is the cheap rung of the mixed-precision ladder
    (``parallel/mixed.py``): the batched matvec is HBM-bandwidth-bound, so
    a bfloat16-resident ``A`` halves the bytes per sweep and lowers to a
    bf16 x bf16 -> f32 product.  Solutions obtained through this
    operator carry an operator-error floor in the TRUE residual of roughly
    ``2^-8 ||A||`` — self-reported residuals keep decreasing below it (the
    solver sees a consistent, slightly wrong A), so a full-precision polish
    phase must follow.  Measured on the headline ensemble (n=1000 Wishart,
    box): true-residual floor ~2e-2 normalized, vs f32's ~1e-7.
    """

    A: jax.Array          # bfloat16 (or other storage dtype)

    @staticmethod
    def from_f32(A, dtype=jnp.bfloat16):
        return CastDense(jnp.asarray(A).astype(dtype))

    def matvec(self, x):
        return _gemv_fence(jnp.dot(self.A, x.astype(self.A.dtype),
                                   preferred_element_type=x.dtype))

    def inf_norm(self):
        return jnp.max(jnp.sum(jnp.abs(self.A.astype(jnp.float32)), axis=-1))

    def diagonal(self):
        return jnp.diagonal(self.A).astype(jnp.float32)


@register_pytree_dataclass
class MixedPrecDense(LinearOperator):
    """Dense operator carrying BOTH precisions: ``matvec`` streams the
    bfloat16-resident copy (half the HBM bytes; its time on the card is not
    measured yet), ``matvec_exact`` streams the float32 original at HIGHEST
    precision.

    This is the operand of the residual-replacement mixed-precision PCG
    (``models.pcg`` with ``refresh_every > 0``): the CG recurrence rides the
    cheap sweeps, the periodic gradient refresh and every reported residual
    ride the exact one.  Build with ``MixedPrecDense.from_f32(A)`` or from
    the pair ``parallel.prepare_dense_batch(As, jnp.bfloat16)`` returns.
    """

    A: jax.Array          # float32 (or float64 for the f64-exact ladder)
    A_low: jax.Array      # bfloat16/float32 copy of A

    @staticmethod
    def from_f32(A, dtype=jnp.bfloat16):
        A = jnp.asarray(A)
        return MixedPrecDense(A, A.astype(dtype))

    def matvec(self, x):
        # ACCURACY CONTRACT: ``matvec`` is the deliberately-cheap sweep of
        # the residual-replacement ladder — its accuracy is that of the
        # low-precision copy, NOT the carry dtype.  Accuracy-sensitive
        # callers (anything outside the rr-PCG refresh loop that needs the
        # true operator) must use ``matvec_exact``.
        #
        # Accumulation dtype: normally promote(carry, f32) — an f64 carry
        # keeps f64 accumulation even over a bf16/f32 low copy (advisor
        # r4: the fast path must be opted into, not inherited by every
        # direct caller).  The ONE exception is keyed on the HIGH copy
        # being f64 — the f64-exact ladder configuration (A f64, A_low
        # f32; benchmark_f64_wishart1k.py), whose whole point is that the
        # cheap sweep stays a native-f32 GEMV: requesting f64 accumulation
        # of an f32 matmul would turn it into an f64 GEMV.  In that
        # configuration the refresh loop
        # corrects the accumulation error like any other operator error.
        if self.A.dtype == jnp.float64:
            acc = jnp.promote_types(self.A_low.dtype, jnp.float32)
        else:
            acc = jnp.promote_types(x.dtype, jnp.float32)
        y = jnp.dot(self.A_low, x.astype(self.A_low.dtype),
                    preferred_element_type=acc)
        # NO _gemv_fence here: the cheap sweep stays fusible with its
        # cast-to-carry consumer.  A barrier between the f32 dot and the
        # f64 cast once degraded the products of this mixed-dtype sweep
        # and stalled the f64-exact rung's refinement; the barrier is
        # meant for same-dtype GEMVs (DenseOperator/FastDense).
        return y.astype(x.dtype)

    def matvec_exact(self, x):
        return _gemv_fence(jnp.dot(self.A, x, preferred_element_type=x.dtype,
                                   precision=_PRECISION))

    def inf_norm(self):
        return jnp.max(jnp.sum(jnp.abs(self.A), axis=-1))

    def diagonal(self):
        return jnp.diagonal(self.A)


@register_pytree_dataclass(meta_fields=("axis", "axis_size"))
class ShardedDenseOperator(LinearOperator):
    """Row-block-sharded dense operator for use inside ``shard_map``.

    Each shard holds the local row block ``A_local: (n_local, n)`` of A and
    the solver carries the *sharded* iterate ``x_local: (n_local,)``.  The
    matvec all-gathers x along ``axis`` and computes the
    local GEMV; dot products / norms / feasible-step minima psum/pmin their
    per-shard partials, so the *unchanged* solver kernels run correctly
    distributed.  The reference has no distributed path (SURVEY.md
    section 2.8).

    Constraint: the projection must be separable (box/bounds/identity) or
    blockwise with blocks aligned to the shard boundary — global-norm sets
    (ball, cone spanning shards) would need their own collectives.
    """

    A_local: jax.Array
    axis: str
    axis_size: int

    def matvec(self, x_local):
        x_full = lax.all_gather(x_local, self.axis, tiled=True)
        return jnp.dot(self.A_local, x_full,
                       preferred_element_type=x_local.dtype,
                       precision=_PRECISION)

    def dot(self, u, v):
        return lax.psum(jnp.vdot(u, v), self.axis)

    def inf_norm(self):
        return lax.pmax(jnp.max(jnp.sum(jnp.abs(self.A_local), axis=-1)), self.axis)

    def global_size(self, x):
        return x.shape[-1] * self.axis_size

    def reduce_min(self, v):
        return lax.pmin(v, self.axis)

    def diagonal(self):
        """Local shard of diag(A): row i of the shard owns global row
        shard_index * n_local + i.

        CONTRACT: shards must be EQUAL CONTIGUOUS row blocks in shard-index
        order — global row r lives on shard r // n_local (exactly what
        ``parallel.sharded.solve_sharded`` produces with a PartitionSpec over
        the row axis).  A non-contiguous or permuted row sharding would make
        this offset arithmetic silently pick off-diagonal entries (wrong
        Jacobi preconditioning); such layouts need their own operator."""
        n_local, n_global = self.A_local.shape
        assert n_local * self.axis_size == n_global, (
            f"ShardedDenseOperator.diagonal requires equal contiguous row "
            f"blocks: n_local={n_local} * axis_size={self.axis_size} != "
            f"n={n_global}")
        offset = lax.axis_index(self.axis) * n_local
        cols = offset + jnp.arange(n_local)
        return self.A_local[jnp.arange(n_local), cols]


@register_pytree_dataclass(meta_fields=("axis", "axis_size", "n"))
class ShardedBlockSparseOperator(LinearOperator):
    """Row-block-sharded block-sparse (ELL) operator for ``shard_map``.

    The BASELINE.json "single huge QP: n=1M block-sparse A row-sharded"
    configuration: a dense n=1M Hessian is 4 TB (impossible),
    but contact-mechanics Hessians are block-sparse with O(1) blocks per row,
    so the whole operator is ~n * k_max * bs * 4 bytes — a few GB spread over
    the mesh.  Each shard holds the ELL rows it owns (``blocks``/``cols`` as
    in ``BlockSparseOperator`` but with *global* block-column ids) and the
    solver carries the sharded iterate.  matvec = all-gather x +
    local gather + batched small GEMM; reductions psum/pmin as in
    ``ShardedDenseOperator``.

    Communication per iteration: ONE tiled all-gather of x (n floats) and
    O(few) scalar psums — identical collective pattern to the dense sharded
    path, so iterations/s scaling is set by the all-gather, not the local
    SpMV.

    Shapes (per shard): blocks (nbr_local, k_max, bs, bs);
    cols (nbr_local, k_max) int32 GLOBAL block-column ids; n = global dim.
    """

    blocks: jax.Array
    cols: jax.Array
    axis: str
    axis_size: int
    n: int

    def matvec(self, x_local):
        x_full = lax.all_gather(x_local, self.axis, tiled=True)
        nbr, kmax, bs, _ = self.blocks.shape
        xb = x_full.reshape(self.n // bs, bs)
        gathered = xb[self.cols]                       # (nbr, kmax, bs)
        prod = jnp.einsum("rkij,rkj->rki", self.blocks, gathered,
                          preferred_element_type=x_local.dtype,
                          precision=_PRECISION)
        return jnp.sum(prod, axis=1).reshape(x_local.shape)

    def dot(self, u, v):
        return lax.psum(jnp.vdot(u, v), self.axis)

    def inf_norm(self):
        local = jnp.max(jnp.sum(jnp.abs(self.blocks), axis=(1, 3)))
        return lax.pmax(local, self.axis)

    def global_size(self, x):
        return self.n

    def reduce_min(self, v):
        return lax.pmin(v, self.axis)

    def diagonal(self):
        """Local shard of diag(A): shard s owns global block-rows
        [s*nbr_local, (s+1)*nbr_local).

        CONTRACT (as in ShardedDenseOperator.diagonal): equal contiguous
        block-row shards in shard-index order — what
        ``parallel.sharded.solve_sharded_blocksparse`` produces.  Permuted or
        ragged shardings would match the wrong ``cols`` entries and return
        off-diagonal values."""
        nbr, kmax, bs, _ = self.blocks.shape
        assert nbr * self.axis_size * bs == self.n, (
            f"ShardedBlockSparseOperator.diagonal requires equal contiguous "
            f"block-row shards: nbr_local={nbr} * axis_size={self.axis_size} "
            f"* bs={bs} != n={self.n}")
        offset = lax.axis_index(self.axis) * nbr
        row_ids = offset + jnp.arange(nbr, dtype=self.cols.dtype)[:, None]
        on_diag = (self.cols == row_ids).astype(self.blocks.dtype)
        diag_blocks = jnp.einsum("rkij,rk->rij", self.blocks, on_diag,
                                 precision=_PRECISION)
        return jnp.diagonal(diag_blocks, axis1=-2, axis2=-1).reshape(nbr * bs)


@register_pytree_dataclass
class SpectralDense(LinearOperator):
    """Dense operator carrying per-problem spectral bounds (L, mu).

    The operand of the strong-convexity accelerated projected gradient
    (``models.apgd.solve_sc``): L >= lambda_max sets the step 1/L, mu <=
    lambda_min sets the optimal constant momentum.  Both are pytree leaves,
    so batched ensembles stack them with a leading axis and every batched
    pipeline (``solve_batched``, fused compaction gathers) handles them
    transparently.  Build bounds with ``estimate_spectral_bounds`` — a
    one-time, amortizable prep for fixed ensembles (the same status as the
    Jacobi diagonal / Cholesky-inverse preps, bench.py).
    """

    A: jax.Array
    L: jax.Array
    mu: jax.Array

    def matvec(self, x):
        return _gemv_fence(jnp.dot(self.A, x, preferred_element_type=x.dtype,
                                   precision=_PRECISION))

    def inf_norm(self):
        return jnp.max(jnp.sum(jnp.abs(self.A), axis=-1))

    def diagonal(self):
        return jnp.diagonal(self.A)

    def spectral_bounds(self):
        return self.L, self.mu


def estimate_spectral_bounds(As, iters=32, safety=0.02):
    """Per-lane (L, mu) estimates for a stacked SPD batch (B, n, n).

    lambda_max via power iteration; lambda_min via SHIFTED power iteration
    on ``c I - A`` with ``c`` just above the lambda_max estimate (the
    largest eigenvalue of the shifted operator is ``c - lambda_min``) — no
    factorization needed, ~``2 * iters`` matvecs per lane, one-time.
    Power iteration approaches lambda_max FROM BELOW, so the returned
    ``L = (1 + safety) * est`` is inflated to a near-certain upper bound
    and ``mu = (1 - safety) * est`` deflated likewise; both directions are
    CONSERVATIVE for solve_sc (a loose L/mu costs a few iterations, an
    invalid L can diverge).  2 * 32 iterations leaves the dominant-gap
    residual well under the 2% margin on non-degenerate spectra.
    """
    As = jnp.asarray(As)
    B, n, _ = As.shape

    def lam_max(A_i, M_shift):
        # power iteration on (M_shift * I - A) when M_shift > 0 else on A.
        v0 = jnp.ones((n,), As.dtype) / jnp.sqrt(jnp.asarray(n, As.dtype))

        def apply(v):
            Av = jnp.dot(A_i, v, preferred_element_type=v.dtype,
                         precision=_PRECISION)
            return jnp.where(M_shift > 0, M_shift * v - Av, Av)

        def body(i, v):
            w = apply(v)
            return w / (jnp.linalg.norm(w) + jnp.finfo(As.dtype).tiny)

        v = lax.fori_loop(0, int(iters), body, v0)
        return jnp.vdot(v, apply(v))

    lmax = jax.jit(jax.vmap(lambda A_i: lam_max(A_i, jnp.asarray(0.0, As.dtype))))(As)
    L = (1.0 + safety) * lmax
    shift = L * 1.01
    lmax_shifted = jax.jit(jax.vmap(lam_max))(As, shift)
    mu = jnp.maximum((1.0 - safety) * (shift - lmax_shifted), 0.0)
    return L, mu


def as_operator(A) -> LinearOperator:
    """Wrap a raw array as a DenseOperator; pass operators through."""
    if isinstance(A, LinearOperator):
        return A
    return DenseOperator(jnp.asarray(A))
