"""The distributed layer's host tables (h2gcn_tpu_torch.parallel) against the
JAX package's, with no process group.

The allgather, ring and halo builders and the dest-stripe attention
builder port one for one: their arrays must equal the JAX package's
exactly at D = 2, 4 and 8. halo-cootile keeps the port's own chunk
geometry, so its per-shard interior and halo matrices are compared
(densified from the JAX package's chunk tables), and its local reduces,
run on each shard with the receive buffer built on the host from the send
tables, must give the JAX package's ``dist_spmm_halo_cootile`` result (its
Pallas kernel in interpret mode on the 8-device CPU mesh) at 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch
from jax.sharding import PartitionSpec as P

from h2gcn_tpu.parallel import attention as j_attn
from h2gcn_tpu.parallel import dist as j_dist
from h2gcn_tpu.parallel.mesh import make_mesh as j_make_mesh
from h2gcn_tpu.sparse import transforms as j_transforms
from h2gcn_tpu_torch.parallel import attention as t_attn
from h2gcn_tpu_torch.parallel import dist as t_dist
from h2gcn_tpu_torch.parallel import train as t_train
from h2gcn_tpu_torch.parallel.mesh import Mesh
from h2gcn_tpu_torch.sparse import spmm

FIELDS = {
    "allgather": ("rows", "cols", "vals"),
    "ring": ("rows", "cols", "vals"),
    "halo": ("rows_int", "cols_int", "vals_int", "rows_halo", "cols_halo",
             "vals_halo", "send_idx"),
}


@pytest.fixture(scope="module")
def problem():
    """test_parallel.py's problem: 120 nodes, the exact-hop Â₁ and Â₂."""
    rng = np.random.default_rng(0)
    n, f = 120, 24
    A = sp.random(n, n, density=0.06, random_state=1, format="csr")
    A = ((A + A.T) > 0).astype(np.float32)
    A = j_transforms.remove_eye(A)
    hops = j_transforms.nhood_split(A, 2)
    mats = [j_transforms.normalize(hops[1]), j_transforms.normalize(hops[2])]
    support = ((A + sp.eye(n)) > 0).astype(np.float32)
    x = rng.standard_normal((n, f)).astype(np.float32)
    return dict(n=n, mats=mats, support=support, x=x)


@pytest.mark.parametrize("D", [2, 4, 8])
@pytest.mark.parametrize("mode", ["allgather", "ring", "halo"])
def test_tables_equal_jax(problem, mode, D):
    for m in problem["mats"]:
        (t,), t_pad = t_dist.shard_hops([m], D, mode=mode)
        (j,), j_pad = j_dist.shard_hops([m], D, mode=mode)
        assert t_pad == j_pad and t.n_local == j.n_local
        assert t.n_global == j.n_global
        for field in FIELDS[mode]:
            ref = np.asarray(getattr(j, field))
            got = getattr(t, field)
            assert got.dtype == ref.dtype, field
            np.testing.assert_array_equal(got, ref, err_msg=field)
        if mode == "halo":
            assert t.halo == j.halo


def _dense_from_chunks(tb, d):
    """One shard of the JAX package's COO-tile chunk tables, densified."""
    T = tb.tile
    out = np.zeros((tb.n_rows, tb.n_cols), np.float64)
    ctr, ctc = np.asarray(tb.ctr[d]), np.asarray(tb.ctc[d])
    rows, cols = np.asarray(tb.rows[d]), np.asarray(tb.cols[d])
    vals = np.asarray(tb.vals[d])
    r = (ctr[:, None] * T + rows).ravel()
    c = (ctc[:, None] * T + cols).ravel()
    live = vals.ravel() != 0
    np.add.at(out, (r[live], c[live]), vals.ravel()[live])
    return out


@pytest.mark.parametrize("D", [2, 4, 8])
def test_halo_cootile_matrices_equal_jax(problem, D):
    for m in problem["mats"]:
        t, t_pad = t_dist.shard_matrix_halo_cootile(m, D)
        j, j_pad = j_dist.shard_matrix_halo_cootile(m, D, tile=64, e_b=64)
        assert t_pad == j_pad and t.halo == j.halo
        np.testing.assert_array_equal(t.send_idx, np.asarray(j.send_idx))
        for d in range(D):
            for got, fwd, bwd in ((t.interiors[d], j.int_fwd, j.int_bwd),
                                  (t.halos[d], j.halo_fwd, j.halo_bwd)):
                ref = _dense_from_chunks(fwd, d)
                np.testing.assert_array_equal(got.toarray(), ref)
                np.testing.assert_array_equal(got.toarray().T,
                                              _dense_from_chunks(bwd, d))


def _host_exchange(send_idx, xs):
    """Each shard's receive buffer, built on the host: row ``s*H + i`` is
    shard ``s``'s ``send_idx[s, d, i]``-th row."""
    D = len(xs)
    return [np.concatenate([xs[s][send_idx[s, d]] for s in range(D)])
            for d in range(D)]


def test_halo_cootile_spmm_matches_jax(problem):
    """The port's per-shard COO-tile reduces (the plain version of
    csrc/cootile_spmm.cu on the CPU), forward and Aᵀg, against the JAX
    package's dist_spmm_halo_cootile (interpret mode) and scipy."""
    D = 8
    mesh = j_make_mesh(D)
    for m in problem["mats"]:
        j, n_pad = j_dist.shard_matrix_halo_cootile(m, D, tile=64, e_b=64)
        x = j_dist.pad_nodes(problem["x"], n_pad)

        def body(sh, x_local):
            return j_dist.dist_spmm_halo_cootile(sh.local(), x_local)

        f = jax.jit(jax.shard_map(
            body, mesh=mesh,
            in_specs=(jax.tree_util.tree_map(lambda _: P("graph"), j),
                      P("graph")),
            out_specs=P("graph"), check_vma=False))
        ref = np.asarray(f(j, jnp.asarray(x)))

        t, _ = t_dist.shard_matrix_halo_cootile(m, D)
        xs = np.split(x, D)
        recvs = _host_exchange(t.send_idx, xs)
        outs = []
        for d in range(D):
            sh = t.local(Mesh(rank=d, size=D, device=torch.device("cpu")))
            assert sh.interior.backend == sh.halo_mat.backend == "cootile"
            xd = torch.from_numpy(xs[d])
            outs.append(spmm(sh.interior, xd)
                        + spmm(sh.halo_mat, torch.from_numpy(recvs[d])))
        got = torch.cat(outs).numpy()
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got[:problem["n"]], m @ problem["x"],
                                   rtol=1e-5, atol=1e-5)
        # Aᵀg: the interior's and halo's transposes, summed back to owners
        g = np.random.default_rng(3).standard_normal(x.shape).astype(
            np.float32)
        gs = np.split(g, D)
        back = [np.zeros_like(xs[d]) for d in range(D)]
        for d in range(D):
            sh = t.local(Mesh(rank=d, size=D, device=torch.device("cpu")))
            xd = torch.from_numpy(xs[d]).requires_grad_()
            rd = torch.from_numpy(recvs[d]).requires_grad_()
            (spmm(sh.interior, xd) + spmm(sh.halo_mat, rd)).backward(
                torch.from_numpy(gs[d]))
            back[d] += xd.grad.numpy()
            rg = rd.grad.numpy().reshape(D, t.halo, -1)
            for s in range(D):  # the exchange's transpose
                np.add.at(back[s], t.send_idx[s, d], rg[s])
        A = sp.csr_matrix(m, shape=(n_pad, n_pad))
        A.resize((n_pad, n_pad))
        np.testing.assert_allclose(np.concatenate(back), A.T @ g,
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("D", [2, 4])
def test_attention_tables_equal_jax(problem, D):
    """Dest-stripe gather-attention shards at the JAX package's table tile
    (512): send tables, both orientations' stacked tables (with the dead
    step) and the padded edge lists."""
    t, t_pad = t_attn.shard_attention_gather(problem["support"], D, tile=512)
    j, j_pad = j_attn.shard_attention_gather(problem["support"], D)
    assert (t_pad, t.n_local, t.n_cat, t.h_pad, t.e_pad) == (
        j_pad, j.n_local, j.n_cat, j.h_pad, j.e_pad)
    np.testing.assert_array_equal(t.send_idx, np.asarray(j.send_idx))
    np.testing.assert_array_equal(t.rows_e, np.asarray(j.rows_e))
    np.testing.assert_array_equal(t.cols_e, np.asarray(j.cols_e))
    for orient in ("fwd", "bwd"):
        tt, jt = getattr(t, orient), getattr(j, orient)
        assert (tt.n_rows, tt.n_cols, tt.rb) == (jt.n_rows, jt.n_cols, jt.rb)
        for field in ("ctr", "rows", "cols", "vals", "s2e"):
            np.testing.assert_array_equal(getattr(tt, field),
                                          np.asarray(getattr(jt, field)),
                                          err_msg=f"{orient}.{field}")


def test_attention_padding_edges_point_at_the_dead_step(problem):
    t, _ = t_attn.shard_attention_gather(problem["support"], 4)
    for tables in (t.fwd, t.bwd):
        dead = (tables.ctr.shape[1] - 1) * t.kb * t.e_b
        for d in range(4):
            n_edges = int((tables.s2e[d] < t.e_pad).sum())
            assert np.all(tables.slot[d, n_edges:] == dead)
            assert np.all(tables.s2e[d, dead:] == t.e_pad)
            assert np.all(tables.vals[d, -t.kb:] == 0)
            # every real edge's slot maps back to it
            np.testing.assert_array_equal(
                tables.s2e[d, tables.slot[d, :n_edges]], np.arange(n_edges))


@pytest.mark.parametrize("builder", ["halo", "attention"])
def test_self_rows_never_travel(problem, builder):
    """send_idx[d, d] is all padding (zeros) for every shard."""
    if builder == "halo":
        send = t_dist.shard_matrix_halo(problem["mats"][1], 8)[0].send_idx
    else:
        send = t_attn.shard_attention_gather(problem["support"], 8)[0].send_idx
    for d in range(8):
        np.testing.assert_array_equal(send[d, d], 0)


def test_attention_refuses_multi_segment_shards(monkeypatch):
    """A shard whose tables need more than one segment raises, as in the
    JAX package (the step cap of a segment lowered to 1 here)."""
    from h2gcn_tpu_torch.sparse import gscatter

    monkeypatch.setattr(gscatter, "_MAX_STEPS", 1)
    support = sp.csr_matrix(np.ones((64, 64), np.float32))
    with pytest.warns(UserWarning, match="segment buffer bound"):
        with pytest.raises(ValueError, match="single-segment"):
            t_attn.shard_attention_gather(support, 2, tile=8, e_b=8, kb=1)


def test_pad_nodes_and_node_slices():
    a = np.arange(10, dtype=np.float32).reshape(5, 2)
    np.testing.assert_array_equal(t_dist.pad_nodes(a, 5), a)
    padded = t_dist.pad_nodes(a, 8)
    assert padded.shape == (8, 2) and not padded[5:].any()
    np.testing.assert_array_equal(padded, j_dist.pad_nodes(a, 8))
    mesh = Mesh(rank=2, size=4, device=torch.device("cpu"))
    assert t_train.node_slice(mesh, 40) == slice(20, 30)
    with pytest.raises(ValueError, match="not divisible"):
        t_train.node_slice(mesh, 42)


def test_shard_hops_modes():
    m = sp.random(30, 30, density=0.2, random_state=0, format="csr")
    m = (m + m.T).astype(np.float32)
    kinds = {"allgather": t_dist.ShardedMatrix,
             "ring": t_dist.RingShardedMatrix,
             "halo": t_dist.HaloShardedMatrix,
             "halo-cootile": t_dist.HaloCooTileMatrix}
    assert set(kinds) == set(t_dist.HALO_MODES)
    for mode, kind in kinds.items():
        shards, n_pad = t_dist.shard_hops([m, m], 4, mode=mode)
        assert n_pad == 32 and len(shards) == 2
        assert all(isinstance(s, kind) for s in shards)
    with pytest.raises(KeyError):
        t_dist.shard_hops([m], 4, mode="scatter")
