"""Sum-factorized (matrix-free geometry) application of the element KLE
operator K — the Deville-Fischer-Mund SEM apply, flat-quadrature form.

On unstructured/hex meshes every element has its own geometry, so the
engine's dense path stores a per-element K of (nnode·dim)² floats —
147 KB/element at 3D ngl=4, several GB at production cell counts, and every
CG iteration streams all of it from HBM (the reference never faces this:
PETSc assembles one global CSR, `src/matrices/mat_fs.py:131-201`). The
sum-factorized form stores only per-quadrature-point geometry:

    full family:  G[q]  = w_q |J_q| · J_q⁻¹ J_q⁻ᵀ   (dim×dim symmetric)
    reduced:      Jr[q] = J_q⁻¹,  wr[q] = w_q |J_q|

≈ 2.6 KB/element at 3D ngl=4 — 56× less HBM traffic per apply.

Shape of the computation: the classic per-axis tensor passes (contract
one length-N axis at a time with a moveaxis relayout in between) work on
arrays whose trailing dims are N and c. Instead, ALL reference-space
gradients come from ONE shared matmul per quadrature family,

    g = z_cm @ Dstack            Dstack: (nn, dim·nq), columns r-major,
                                 Dstack[:, r·nq+q] = Π_ax A_ax[q_ax, i_ax],
                                 A_ax = D1d if ax == r else H1d

with z_cm the component-major (E·c, nn) view of the element vector; the
dim×dim geometry contractions are unrolled pointwise FMAs over (E, c, nq)
arrays (full f32 elementwise arithmetic, so no matmul precision setting
applies to them); and the transposed scatter Σ_r D_rᵀ s_r is one matmul
with Dstackᵀ. Four shared matmuls total, zero relayout passes.

Exactly reproduces `elements/kle.py compute_kle_matrices` (same quadrature
families, reference `src/domain/elements/spectral.py:96-160`); equivalence
against the dense per-element K on random distorted meshes is tested in
`tests/test_sumfact.py`. Wired into the engine for unstructured meshes
(engine flag `sumfact`, on by default there — see
`local_engine.build_engine`).
"""
from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from pynama_tpu.basis.lagrange import lagrange_basis
from pynama_tpu.basis.quadrature import gauss_points, lobatto_points
from pynama_tpu.elements.kle import ALPHA_D, ALPHA_W, curl_tensor

_mm = functools.partial(jnp.matmul, precision=jax.lax.Precision.HIGHEST)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class SumFactK:
    """Per-element geometric factors + shared flat tables for one mesh.

    Per-element arrays (leading E axis — the sharded engine splits these
    per slab): Gt, Jrt, wr. Shared arrays (broadcast when sharded):
    Df_flat, Dr_flat, v2cm, cm2v.
    """
    #: (E, dim, dim, nqf) full-family w|J|·J⁻¹J⁻ᵀ, Gt[e,r,s,q] (symmetric)
    Gt: jax.Array
    #: (E, dim, dim, nqr) reduced-family J⁻¹, Jrt[e,p,r,q]:
    #: ∂u/∂x_p = Σ_r Jrt[p,r] ∂u/∂ξ_r
    Jrt: jax.Array
    #: (E, nqr) reduced-family w|J|
    wr: jax.Array
    #: stacked flat derivative operators, (nn, dim·nq), columns r-major
    Df_flat: jax.Array
    Dr_flat: jax.Array
    #: column gathers: interleaved (node-major) <-> component-major
    v2cm: jax.Array
    cm2v: jax.Array
    dim: int = dataclasses.field(metadata=dict(static=True))
    ngl: int = dataclasses.field(metadata=dict(static=True))
    alpha_w: float = dataclasses.field(default=ALPHA_W,
                                       metadata=dict(static=True))
    alpha_d: float = dataclasses.field(default=ALPHA_D,
                                       metadata=dict(static=True))

    @property
    def nqf(self):
        return self.Gt.shape[-1]

    @property
    def nqr(self):
        return self.wr.shape[-1]


def _family_geometry(DCoo: np.ndarray, weights: np.ndarray,
                     corners: np.ndarray):
    """Jinv (E, nq, dim, dim) and w|J| (E, nq) from corner coords."""
    J = np.einsum('qra,eap->eqrp', DCoo, corners)
    detJ = np.abs(np.linalg.det(J))   # w|J|: orientation-safe
    Jinv = np.linalg.inv(J)
    return Jinv, weights[None, :] * detJ


def _flat_stack(H: np.ndarray, D: np.ndarray, dim: int) -> np.ndarray:
    """(nn, dim·nq) stacked kron operators, q-major rows (q0 slowest),
    i-major columns (i0 slowest) — matching the canonical tensor orders
    of both the element vector and the families' DCoo point grids."""
    blocks = []
    for r in range(dim):
        M = np.ones((1, 1))
        for ax in range(dim):
            M = np.kron(M, D if ax == r else H)
        blocks.append(M.T)                       # (nn, nq)
    return np.concatenate(blocks, axis=1)        # (nn, dim*nq)


def build_sumfact(basis, corners: np.ndarray, dtype,
                  alpha_w: float = ALPHA_W,
                  alpha_d: float = ALPHA_D) -> SumFactK:
    """SumFactK from a TensorBasis and (E, 2**dim, dim) corner coords."""
    dim, ngl = basis.dim, basis.ngl
    nn = ngl ** dim
    corners = np.asarray(corners, dtype=np.float64)
    if corners.ndim == 2:
        corners = corners[None]

    Jf, wf = _family_geometry(basis.full.DCoo, basis.full.weights, corners)
    # G[e,q,r,s] = w|J| Σ_p Jinv[p,r] Jinv[p,s] -> transpose q last
    G = np.einsum('eq,eqpr,eqps->eqrs', wf, Jf, Jf)
    Jr, wr = _family_geometry(basis.reduced.DCoo, basis.reduced.weights,
                              corners)

    nodes1d, _ = lobatto_points(ngl)
    if ngl <= 3:
        fq, _ = gauss_points(ngl)
    else:
        fq, _ = lobatto_points(ngl)
    rq, _ = gauss_points(ngl - 1)
    Hf, Df = lagrange_basis(nodes1d, fq)
    Hr, Dr = lagrange_basis(nodes1d, rq)

    dst = np.arange(dim * nn)
    v2cm = ((dst % nn) * dim + dst // nn).astype(np.int32)
    cm2v = ((dst % dim) * nn + dst // dim).astype(np.int32)

    j = lambda a: jnp.asarray(a, dtype=dtype)
    return SumFactK(
        Gt=j(np.moveaxis(G, 1, -1)),             # (E, r, s, nqf)
        Jrt=j(np.moveaxis(Jr, 1, -1)),           # (E, p, r, nqr)
        wr=j(wr),
        Df_flat=j(_flat_stack(Hf, Df, dim)),
        Dr_flat=j(_flat_stack(Hr, Dr, dim)),
        v2cm=jnp.asarray(v2cm), cm2v=jnp.asarray(cm2v),
        dim=dim, ngl=ngl,
        alpha_w=float(alpha_w), alpha_d=float(alpha_d))


def apply_sumfact_k(sf: SumFactK, t: jax.Array) -> jax.Array:
    """y = t @ K_eᵀ per element, (E, nnode·dim) -> (E, nnode·dim): the
    un-assembled element product (caller DSSes, as with the dense path)."""
    dim, N = sf.dim, sf.ngl
    nn = N ** dim
    E = t.shape[0]
    nqf, nqr = sf.nqf, sf.nqr
    Tc = curl_tensor(dim)                         # host numpy, static
    dim_w = Tc.shape[0]

    zc = t[:, sf.v2cm].reshape(E * dim, nn)       # component-major rows

    # ---- reference-space gradients, both families: ONE matmul each
    gf = _mm(zc, sf.Df_flat).reshape(E, dim, dim, nqf)   # [e, c, r, q]
    gr = _mm(zc, sf.Dr_flat).reshape(E, dim, dim, nqr)

    # ---- stiffness cotangent: s[p,c] = Σ_r G[r,p] g[r,c]  (G symmetric)
    s_p = []
    for p in range(dim):
        acc = None
        for r in range(dim):
            term = sf.Gt[:, r, p, :][:, None, :] * gf[:, :, r, :]
            acc = term if acc is None else acc + term
        s_p.append(acc)                           # (E, c, nqf)

    # ---- penalties: physical gradient gp[p][e,c,q] = ∂u_c/∂x_p
    gp = []
    for p in range(dim):
        acc = None
        for r in range(dim):
            term = sf.Jrt[:, p, r, :][:, None, :] * gr[:, :, r, :]
            acc = term if acc is None else acc + term
        gp.append(acc)
    div = None                                    # (E, nqr)
    for c in range(dim):
        d = gp[c][:, c, :]
        div = d if div is None else div + d
    curl_w = []
    for w in range(dim_w):
        acc = None
        for c in range(dim):
            for d in range(dim):
                tv = float(Tc[w, c, d])
                if tv == 0.0:
                    continue
                term = tv * gp[d][:, c, :]
                acc = term if acc is None else acc + term
        curl_w.append(acc)                        # (E, nqr)

    # cotangent sp[p][e,c,q] = α_d w div δ_pc + α_w w Σ_w T[w,c,p] curl_w
    wdiv = sf.alpha_d * (sf.wr * div)
    sp = []
    for p in range(dim):
        cols = []
        for c in range(dim):
            val = wdiv if c == p else None
            for w in range(dim_w):
                tv = float(Tc[w, c, p])
                if tv == 0.0:
                    continue
                term = (sf.alpha_w * tv) * (sf.wr * curl_w[w])
                val = term if val is None else val + term
            if val is None:
                val = jnp.zeros((E, nqr), dtype=t.dtype)
            cols.append(val)
        sp.append(jnp.stack(cols, axis=1))        # (E, c, nqr)

    # back to reference axes: sr[r][e,c,q] = Σ_p Jr[p,r] sp[p]
    sr = []
    for r in range(dim):
        acc = None
        for p in range(dim):
            term = sf.Jrt[:, p, r, :][:, None, :] * sp[p]
            acc = term if acc is None else acc + term
        sr.append(acc)

    # ---- transposed scatters: one matmul per family with Dstackᵀ
    sf_stack = jnp.stack(s_p, axis=2).reshape(E * dim, dim * nqf)
    sr_stack = jnp.stack(sr, axis=2).reshape(E * dim, dim * nqr)
    y = _mm(sf_stack, sf.Df_flat.T) + _mm(sr_stack, sf.Dr_flat.T)
    return y.reshape(E, dim * nn)[:, sf.cm2v]
