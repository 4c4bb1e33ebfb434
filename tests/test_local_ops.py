"""Differential tests: element-local (L-vector) engine vs the generic
incidence-based ElementOp path."""
import numpy as np
import pytest

from pynama_tpu.mesh import BoxMesh
from pynama_tpu.ops.apply import apply_op, assembled_diagonal, \
    make_element_op
from pynama_tpu.ops import local as L


@pytest.mark.parametrize("dim,nelem,ngl", [
    (2, (3, 2), 3), (2, (4, 4), 5), (2, (1, 1), 4), (2, (1, 3), 3),
    (3, (2, 3, 2), 3), (3, (2, 2, 2), 4), (3, (1, 2, 1), 3),
])
@pytest.mark.parametrize("din,dout", [(1, 1), (2, 3), (3, 2)])
def test_local_matches_element_op(dim, nelem, ngl, din, dout):
    nelem = nelem[:dim]
    mesh = BoxMesh.create(ngl, nelem, [0.0] * dim, [1.0] * dim)
    rng = np.random.default_rng(hash((dim, ngl, din, dout)) % 2**31)
    mat = rng.standard_normal((mesh.nnode_el * dout, mesh.nnode_el * din))
    x = rng.standard_normal((mesh.n_nodes, din))

    eop = make_element_op(mat, mesh.cell_nodes, mesh.incidence, din, dout,
                          mesh.n_nodes)
    y_ref = np.asarray(apply_op(eop, x))

    lo = L.make_local_layout(mesh, dout, dtype=np.float64)
    op = L.make_local_op(mat, lo, dtype=np.float64)
    t = L.to_local(mesh, x)
    y_loc = L.apply_local_op(op, t)
    # consistency: duplicated slots must agree after DSS
    y_back = L.to_global(mesh, y_loc, dout)
    np.testing.assert_allclose(y_back, y_ref, rtol=1e-11, atol=1e-11)
    t_ref = L.to_local(mesh, y_ref)
    np.testing.assert_allclose(np.asarray(y_loc), t_ref, rtol=1e-11,
                               atol=1e-11)


def test_local_dot_and_diag():
    mesh = BoxMesh.create(4, (3, 2, 2), [0, 0, 0], [1, 1, 1])
    rng = np.random.default_rng(3)
    d = 3
    a = rng.standard_normal((mesh.n_nodes, d))
    b = rng.standard_normal((mesh.n_nodes, d))
    lo = L.make_local_layout(mesh, d, dtype=np.float64)
    ta, tb = L.to_local(mesh, a), L.to_local(mesh, b)
    got = float(L.local_dot(lo, ta, tb))
    want = float((a * b).sum())
    assert abs(got - want) < 1e-10 * abs(want)

    mat = rng.standard_normal((mesh.nnode_el * d, mesh.nnode_el * d))
    eop = make_element_op(mat, mesh.cell_nodes, mesh.incidence, d, d,
                          mesh.n_nodes)
    op = L.make_local_op(mat, lo, dtype=np.float64)
    diag_ref = np.asarray(assembled_diagonal(eop))
    diag_loc = L.to_global(mesh, np.asarray(L.local_diagonal(op)), d)
    np.testing.assert_allclose(diag_loc, diag_ref, rtol=1e-11, atol=1e-11)


@pytest.mark.parametrize("nelem,ngl,cin,cout", [
    ((3, 4, 5), 4, 3, 3),
    ((3, 4, 5), 4, 3, 6),     # strain-family output (cout != cin)
    ((2, 3), 5, 2, 3),        # 2D
    ((2, 3), 3, 2, 1),        # 2D scalar vorticity
    ((1, 2, 2), 3, 3, 1),     # degenerate axis-0 extent
    ((4, 1, 2), 4, 3, 3),     # degenerate in-slice extent
    ((2, 2, 2), 2, 3, 3),     # ngl=2 (planes cover every column)
])
def test_dss_matches_scatter_add(nelem, ngl, cin, cout):
    """The engine's operator application DSS(t @ matT) against a numpy
    scatter-add over cell_nodes, gathered back to every slot."""
    dim = len(nelem)
    mesh = BoxMesh.create(ngl, list(nelem), [0] * dim, [1] * dim)
    lay = L.make_local_layout(mesh, cout, dtype=np.float64)
    nn = ngl ** dim
    rng = np.random.default_rng(7)
    t = rng.standard_normal((mesh.n_cells, nn * cin))
    matT = rng.standard_normal((nn * cin, nn * cout))
    got = np.asarray(L.dss(lay, L.emm(t, matT)))

    z = (t @ matT).reshape(mesh.n_cells, nn, cout)
    acc = np.zeros((mesh.n_nodes, cout))
    np.add.at(acc, np.asarray(mesh.cell_nodes), z)
    want = acc[np.asarray(mesh.cell_nodes)].reshape(got.shape)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-12 * np.abs(want).max())
