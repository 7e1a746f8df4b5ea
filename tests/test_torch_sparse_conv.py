"""futuredet_torch/ops/sparse_conv.py and K2's plain version against the
JAX package's sparse conv primitives, on the same random site sets.

Tables, output sites and dense scatters must be equal; the JAX tables are
compared on their valid sites, with the JAX absent marker (the capacity V)
read as the port's (the site count N). Conv outputs are fp32 sums over 27
taps taken in another order: atol 1e-5."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from futuredet_tpu.ops import sparse_conv as SC
from futuredet_torch.ops import sparse_conv as PC
from futuredet_torch.ops.pallas_gather import gather_conv, gather_conv_plain

CONV_ATOL = 1e-5


def rand_sites(rng, dims, n, cap):
    """n distinct sites in random order, padded to capacity `cap` for the
    JAX side."""
    lin = rng.choice(int(np.prod(dims)), n, replace=False)
    coords = np.stack([lin // (dims[1] * dims[2]), (lin // dims[2]) % dims[1],
                       lin % dims[2]], -1).astype(np.int32)
    pad = np.zeros((cap, 3), np.int32)
    pad[:n] = coords
    valid = np.zeros(cap, bool)
    valid[:n] = True
    return coords, pad, valid


def both_grids(coords, pad, valid, dims):
    jg = SC.make_grid(jnp.asarray(pad), jnp.asarray(valid), dims)
    pg, _ = PC.make_grid(torch.from_numpy(coords), dims)
    n = len(coords)
    np.testing.assert_array_equal(np.asarray(jg.coords)[:n], pg.coords.numpy())
    return jg, pg


def jax_table_as_port(jtab, n_cols, n_rows_port, cap):
    """(K, cap) JAX table on its first n_cols columns, absent V -> N."""
    t = np.asarray(jtab)[:, :n_cols]
    return np.where(t == cap, n_rows_port, t)


@pytest.mark.parametrize("dims,n", [((41, 16, 16), 600), ((11, 20, 20), 900),
                                    ((5, 12, 12), 120)])
def test_neighbor_table_equals_jax(dims, n):
    rng = np.random.default_rng(n)
    cap = n + 37
    coords, pad, valid = rand_sites(rng, dims, n, cap)
    jg, pg = both_grids(coords, pad, valid, dims)
    got = PC.neighbor_table(pg, dims).numpy()
    want = jax_table_as_port(SC.neighbor_table(jg, dims), n, n, cap)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int32 and (got[13] == np.arange(n)).all()


@pytest.mark.parametrize("dims,pads", [((41, 16, 16), (1, 1, 1)),
                                       ((11, 20, 20), (0, 1, 1)),
                                       ((21, 9, 13), (1, 1, 1))])
def test_downsample_and_strided_table_equal_jax(dims, pads):
    rng = np.random.default_rng(sum(dims))
    n = 500
    cap = n + 11
    coords, pad, valid = rand_sites(rng, dims, n, cap)
    jg, pg = both_grids(coords, pad, valid, dims)
    out_dims = PC.out_dims_of(dims, pads)
    assert out_dims == tuple((d + 2 * p - 3) // 2 + 1
                             for d, p in zip(dims, pads))
    max_out = 8 * cap
    jout, dropped = SC.downsample_coords(jg, out_dims, max_out, pads,
                                         with_dropped=True)
    assert int(dropped) == 0
    pout = PC.downsample_coords(pg, out_dims, pads)
    n_out = len(pout.ids)
    assert int(np.asarray(jout.valid).sum()) == n_out
    np.testing.assert_array_equal(np.asarray(jout.coords)[:n_out],
                                  pout.coords.numpy())
    np.testing.assert_array_equal(np.asarray(jout.ids)[:n_out],
                                  pout.ids.numpy())
    got = PC.strided_gather_table(pg, pout, dims, pads=pads).numpy()
    want = jax_table_as_port(
        SC.strided_gather_table(jg, jout, dims, pads=pads), n_out, n, cap)
    np.testing.assert_array_equal(got, want)


def test_scatter_dense_equals_jax():
    dims = (11, 14, 9)
    rng = np.random.default_rng(7)
    n, cap = 300, 320
    coords, pad, valid = rand_sites(rng, dims, n, cap)
    jg, pg = both_grids(coords, pad, valid, dims)
    feats = rng.normal(size=(cap, 6)).astype(np.float32)
    want = np.asarray(SC.scatter_dense(jnp.asarray(feats), jg, dims))
    got = PC.scatter_dense(torch.from_numpy(feats[:n]), pg, dims)
    assert got.shape == (1, *dims, 6)
    np.testing.assert_array_equal(got[0].numpy(), want)


def conv_case(rng, dims, n, cin, cout, strided):
    cap = n + 9
    coords, pad, valid = rand_sites(rng, dims, n, cap)
    jg, pg = both_grids(coords, pad, valid, dims)
    feats = np.zeros((cap, cin), np.float32)
    feats[:n] = rng.normal(size=(n, cin))
    w = (rng.normal(size=(27, cin, cout)) / np.sqrt(27 * cin)
         ).astype(np.float32)
    b = rng.normal(size=cout).astype(np.float32)
    if strided:
        pads = (1, 1, 1)
        out_dims = PC.out_dims_of(dims, pads)
        jout = SC.downsample_coords(jg, out_dims, 8 * cap, pads)
        pout = PC.downsample_coords(pg, out_dims, pads)
        jtab = SC.strided_gather_table(jg, jout, dims, pads=pads)
        ptab = PC.strided_gather_table(pg, pout, dims, pads=pads)
        xtab = (SC.strided_xpack_tables(jg, jout, dims, pads=pads), jg.valid)
        n_out = len(pout.ids)
    else:
        jtab, ptab = SC.neighbor_table(jg, dims), PC.neighbor_table(pg, dims)
        xtab = (SC.subm_xpack_tables(jg, dims), jg.valid)
        n_out = n
    return feats, w, b, jtab, ptab, xtab, n, n_out


@pytest.mark.parametrize("cin,cout,strided", [(5, 16, False), (16, 16, False),
                                              (16, 32, True), (32, 8, False)])
def test_plain_gather_conv_matches_jax_loop_and_xpack(cin, cout, strided):
    rng = np.random.default_rng(cin * 100 + cout)
    feats, w, b, jtab, ptab, xtab, n, n_out = conv_case(
        rng, (21, 12, 12), 700, cin, cout, strided)
    got = gather_conv(torch.from_numpy(feats[:n]), ptab, torch.from_numpy(w),
                      torch.from_numpy(b)).numpy()
    assert got.shape == (n_out, cout)
    loop = np.asarray(SC.subm_conv_apply(jnp.asarray(feats), jtab,
                                         jnp.asarray(w), jnp.asarray(b),
                                         algo="loop"))[:n_out]
    xpack = np.asarray(SC.subm_conv_apply(jnp.asarray(feats), xtab,
                                          jnp.asarray(w), jnp.asarray(b),
                                          algo="xpack"))[:n_out]
    np.testing.assert_allclose(got, loop, atol=CONV_ATOL, rtol=0)
    np.testing.assert_allclose(got, xpack, atol=CONV_ATOL, rtol=0)


def test_subm_conv_apply_is_k2_and_absent_rows_add_zero():
    """subm_conv_apply runs K2's wrapper; a table all of N gives the bias."""
    rng = np.random.default_rng(11)
    x = torch.from_numpy(rng.normal(size=(50, 8)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(27, 8, 16)).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=16).astype(np.float32))
    tab = torch.full((27, 40), 50, dtype=torch.int32)
    out = PC.subm_conv_apply(x, tab, w, b)
    assert torch.equal(out, b.expand(40, 16))
    tab[5, :10] = torch.arange(10, dtype=torch.int32)
    out = PC.subm_conv_apply(x, tab, w)
    torch.testing.assert_close(out[:10], x[:10] @ w[5], rtol=0, atol=1e-6)
    assert torch.equal(out[10:], torch.zeros(30, 16))
    torch.testing.assert_close(gather_conv_plain(x, tab, w), out, rtol=0,
                               atol=0)


def test_gather_conv_rejects_bad_inputs():
    x = torch.zeros(10, 4)
    w = torch.zeros(27, 4, 16)
    tab = torch.zeros(27, 3, dtype=torch.int32)
    with pytest.raises(ValueError, match="int32"):
        gather_conv(x, tab.long(), w)
    with pytest.raises(ValueError, match="Cin"):
        gather_conv(x, tab, torch.zeros(27, 5, 16))
    with pytest.raises(ValueError, match="27"):
        gather_conv(x, tab[:9], w[:9])
    with pytest.raises(ValueError, match="bias"):
        gather_conv(x, tab, w, torch.zeros(8))


def test_batch_of_two_equals_two_single_samples():
    """Folding the sample into the linear id: one table and one conv for a
    B = 2 batch give each sample's B = 1 tables, sites and outputs."""
    dims = (21, 10, 10)
    rng = np.random.default_rng(13)
    parts = [rand_sites(rng, dims, n, n)[0] for n in (300, 220)]
    feats = [rng.normal(size=(len(c), 16)).astype(np.float32) for c in parts]
    w = (rng.normal(size=(27, 16, 32)) / 20).astype(np.float32)
    w_t = torch.from_numpy(w)
    pads = (1, 1, 1)
    out_dims = PC.out_dims_of(dims, pads)

    def run(coords, batch, x):
        grid, order = PC.make_grid(torch.from_numpy(coords), dims, batch)
        x = torch.from_numpy(x)[order]
        sub = PC.subm_conv_apply(x, PC.neighbor_table(grid, dims),
                                 torch.from_numpy(w[:, :, :16]))
        out = PC.downsample_coords(grid, out_dims, pads)
        down = PC.subm_conv_apply(
            x, PC.strided_gather_table(grid, out, dims, pads=pads), w_t)
        return grid, sub, out, down

    singles = [run(c, None, f) for c, f in zip(parts, feats)]
    batch = torch.cat([torch.full((len(c),), b) for b, c in enumerate(parts)])
    grid, sub, out, down = run(np.concatenate(parts), batch,
                               np.concatenate(feats))
    n0, m0 = len(singles[0][0].ids), len(singles[0][2].ids)
    for b, (g1, s1, o1, d1) in enumerate(singles):
        rows = slice(0, n0) if b == 0 else slice(n0, None)
        outs = slice(0, m0) if b == 0 else slice(m0, None)
        assert torch.equal(grid.coords[rows], g1.coords)
        assert (grid.batch[rows] == b).all() and (out.batch[outs] == b).all()
        assert torch.equal(out.coords[outs], o1.coords)
        torch.testing.assert_close(sub[rows], s1, rtol=0, atol=CONV_ATOL)
        torch.testing.assert_close(down[outs], d1, rtol=0, atol=CONV_ATOL)
