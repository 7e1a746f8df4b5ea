"""The sparse convs' gradients and the train-mode BatchNorms of
futuredet_torch against the JAX package, on the same random sites:

  * `strided_inverse_table` equals the JAX table on zero-drop sites (the
    JAX absent marker, its capacity, read as the port's site count);
  * the sparse conv's dx, dW and db equal those of the JAX custom VJPs
    `_subm_conv_sym_vjp` and `_strided_conv_vjp` within 1e-5 of
    max(1, max |JAX|) (fp32 sums over 27 taps or over the sites, in
    another order), and the Function
    passes `torch.autograd.gradcheck` on the plain path in float64;
  * `MaskedBatchNorm` in training, pooled and per sample (B = 2, unequal
    site counts, the JAX encoder's `nn.vmap` statistics): outputs and
    gradients within 1e-5 of max(1, max |JAX|), running statistics within
    1e-6; and
    `BatchNorm2d`'s running variance is flax's biased one (1e-6).
"""
import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from futuredet_tpu.models.readers import MaskedBatchNorm as JaxMaskedBN
from futuredet_tpu.ops import sparse_conv as SC
from futuredet_torch.models.layers import BatchNorm2d
from futuredet_torch.models.readers import MaskedBatchNorm
from futuredet_torch.ops import sparse_conv as PC
from tests.test_torch_sparse_conv import (both_grids, jax_table_as_port,
                                          rand_sites)

GRAD_RTOL = 1e-5
BN_ATOL = 1e-5
STAT_ATOL = 1e-6


def strided_case(rng, dims, n, pads):
    cap = n + 11
    coords, pad, valid = rand_sites(rng, dims, n, cap)
    jg, pg = both_grids(coords, pad, valid, dims)
    out_dims = PC.out_dims_of(dims, pads)
    max_out = 8 * cap
    jout, dropped = SC.downsample_coords(jg, out_dims, max_out, pads,
                                         with_dropped=True)
    assert int(dropped) == 0
    pout = PC.downsample_coords(pg, out_dims, pads)
    jinv = SC.strided_inverse_table(
        jg, out_dims, SC._dense_index_rows(jout, out_dims), pads=pads)
    pinv = PC.strided_inverse_table(pg, pout, out_dims, pads=pads)
    return dict(cap=cap, max_out=max_out, jg=jg, pg=pg, jout=jout, pout=pout,
                jinv=jinv, pinv=pinv, n=n, n_out=len(pout.ids))


@pytest.mark.parametrize("dims,pads", [((41, 16, 16), (1, 1, 1)),
                                       ((11, 20, 20), (0, 1, 1)),
                                       ((21, 9, 13), (1, 1, 1))])
def test_strided_inverse_table_equals_jax(dims, pads):
    c = strided_case(np.random.default_rng(sum(dims)), dims, 500, pads)
    got = c["pinv"].numpy()
    assert got.shape == (27, c["n"]) and got.dtype == np.int32
    want = jax_table_as_port(c["jinv"], c["n"], c["n_out"], c["max_out"])
    np.testing.assert_array_equal(got, want)
    # it inverts the strided gather table: tab[k][inv[k][u]] == u
    tab = PC.strided_gather_table(c["pg"], c["pout"], dims, pads=pads)
    k, u = np.nonzero(got < c["n_out"])
    assert len(k) > c["n"]
    np.testing.assert_array_equal(tab.numpy()[k, got[k, u]], u)
    assert int((tab < c["n"]).sum()) == len(k)


def conv_inputs(rng, rows, cin, cout, n_out_rows):
    x = rng.normal(size=(rows, cin)).astype(np.float32)
    w = (rng.normal(size=(27, cin, cout)) / np.sqrt(27 * cin)).astype(
        np.float32)
    b = rng.normal(size=cout).astype(np.float32)
    gy = rng.normal(size=(n_out_rows, cout)).astype(np.float32)
    return x, w, b, gy


def assert_close_of_max(got, want, name):
    """Within GRAD_RTOL of max(1, max |want|): sums over 27 taps (out, dx)
    or over the sites (dW, db) in another order."""
    tol = GRAD_RTOL * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, atol=tol, rtol=0, err_msg=name)


def port_grads(x, table, w, b, gy, inverse_table=None):
    xt, wt, bt = (torch.from_numpy(a).requires_grad_() for a in (x, w, b))
    out = PC.subm_conv_apply(xt, table, wt, bt, inverse_table)
    out.backward(torch.from_numpy(gy))
    return out.detach().numpy(), xt.grad.numpy(), wt.grad.numpy(), \
        bt.grad.numpy()


def jax_grads(fn, x, w, b, gy):
    out, vjp = jax.vjp(fn, jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    return (np.asarray(out),) + tuple(np.asarray(g) for g in
                                      vjp(jnp.asarray(gy)))


@pytest.mark.parametrize("cin,cout", [(16, 16), (32, 16), (8, 32)])
def test_submanifold_conv_gradients_match_jax(cin, cout):
    rng = np.random.default_rng(cin + cout)
    dims, n = (21, 12, 12), 700
    cap = n + 9
    coords, pad, valid = rand_sites(rng, dims, n, cap)
    jg, pg = both_grids(coords, pad, valid, dims)
    jtab, ptab = SC.neighbor_table(jg, dims), PC.neighbor_table(pg, dims)
    x, w, b, gy = conv_inputs(rng, cap, cin, cout, cap)
    x[n:] = 0.0
    gy[n:] = 0.0
    want = jax_grads(lambda a, k, c: SC._subm_conv_sym_vjp(
        a, jtab, k, c, None, "loop"), x, w, b, gy)
    got = port_grads(x[:n], ptab, w, b, gy[:n])
    for name, g, wv in zip(("out", "dx", "dW", "db"), got, want):
        if name in ("out", "dx"):
            wv = wv[:n]
        assert_close_of_max(g, wv, name)


@pytest.mark.parametrize("cin,cout,pads", [(16, 32, (1, 1, 1)),
                                           (32, 64, (0, 1, 1))])
def test_strided_conv_gradients_match_jax(cin, cout, pads):
    rng = np.random.default_rng(cin * cout)
    dims = (11, 20, 20) if pads[0] == 0 else (21, 12, 12)
    c = strided_case(rng, dims, 600, pads)
    jtab = SC.strided_gather_table(c["jg"], c["jout"], dims, pads=pads)
    ptab = PC.strided_gather_table(c["pg"], c["pout"], dims, pads=pads)
    n, n_out = c["n"], c["n_out"]
    x, w, b, gy = conv_inputs(rng, c["cap"], cin, cout, c["max_out"])
    x[n:] = 0.0
    gy[n_out:] = 0.0
    want = jax_grads(lambda a, k, d: SC._strided_conv_vjp(
        a, jtab, c["jinv"], k, d, None, "loop"), x, w, b, gy)
    got = port_grads(x[:n], ptab, w, b, gy[:n_out], c["pinv"])
    for name, g, wv, rows in zip(("out", "dx", "dW", "db"), got, want,
                                 (n_out, n, None, None)):
        assert_close_of_max(g, wv[:rows] if rows else wv, name)
    with pytest.raises(ValueError, match="inverse table"):
        port_grads(x[:n], ptab, w, b, gy[:n_out])


def test_gradcheck_on_the_plain_path_in_float64():
    """Submanifold and strided, with and without bias, against finite
    differences; dx is skipped where the input needs no gradient."""
    rng = np.random.default_rng(5)
    dims = (5, 6, 6)
    coords = rand_sites(rng, dims, 40, 40)[0]
    grid, _ = PC.make_grid(torch.from_numpy(coords), dims)
    pads = (1, 1, 1)
    out_dims = PC.out_dims_of(dims, pads)
    ngrid = PC.downsample_coords(grid, out_dims, pads)
    tables = {
        "subm": (PC.neighbor_table(grid, dims), None),
        "strided": (PC.strided_gather_table(grid, ngrid, dims, pads=pads),
                    PC.strided_inverse_table(grid, ngrid, out_dims,
                                             pads=pads))}

    def t64(*shape):
        return torch.from_numpy(rng.normal(size=shape)).requires_grad_()

    for name, (tab, inv) in tables.items():
        x, w, b = t64(40, 3), t64(27, 3, 2), t64(2)
        assert torch.autograd.gradcheck(
            lambda x, w, b: PC.subm_conv_apply(x, tab, w, b, inv),
            (x, w, b)), name
        assert torch.autograd.gradcheck(
            lambda w: PC.subm_conv_apply(x.detach(), tab, w, None, inv),
            (w,)), name


def test_the_function_runs_k2s_wrapper_in_both_directions(monkeypatch):
    """Forward: one gather_conv; backward: one more for dx, none where the
    input needs no gradient (conv_input's voxel features)."""
    calls = []
    real = PC.gather_conv

    def counting(f, t, w, b=None):
        calls.append((tuple(f.shape), tuple(w.shape)))
        return real(f, t, w, b)

    monkeypatch.setattr(PC, "gather_conv", counting)
    rng = np.random.default_rng(9)
    coords = rand_sites(rng, (5, 8, 8), 100, 100)[0]
    grid, _ = PC.make_grid(torch.from_numpy(coords), (5, 8, 8))
    tab = PC.neighbor_table(grid, (5, 8, 8))
    w = torch.from_numpy(rng.normal(size=(27, 5, 16)).astype(np.float32)
                         ).requires_grad_()
    x = torch.from_numpy(rng.normal(size=(100, 5)).astype(np.float32))
    PC.subm_conv_apply(x, tab, w).sum().backward()
    assert calls == [((100, 5), (27, 5, 16))]
    x.requires_grad_()
    PC.subm_conv_apply(x, tab, w).sum().backward()
    assert calls[1:] == [((100, 5), (27, 5, 16)), ((100, 16), (27, 16, 5))]


def test_inference_does_not_enter_the_function(monkeypatch):
    """Under no_grad, and where no input needs a gradient, the sparse conv
    is one K2 call outside the autograd Function, with the same result."""
    rng = np.random.default_rng(10)
    coords = rand_sites(rng, (5, 8, 8), 100, 100)[0]
    grid, _ = PC.make_grid(torch.from_numpy(coords), (5, 8, 8))
    tab = PC.neighbor_table(grid, (5, 8, 8))
    w = torch.from_numpy(rng.normal(size=(27, 8, 16)).astype(np.float32))
    x = torch.from_numpy(rng.normal(size=(100, 8)).astype(np.float32))
    want = PC.subm_conv_apply(x, tab, w.clone().requires_grad_()).detach()

    def refuse(*a):
        raise AssertionError("entered the autograd Function")
    monkeypatch.setattr(PC.SparseConvFunction, "apply", refuse)
    assert torch.equal(PC.subm_conv_apply(x, tab, w), want)
    with torch.no_grad():
        assert torch.equal(PC.subm_conv_apply(x, tab, w.requires_grad_()),
                           want)


def bn_variables(rng, C):
    params = {"scale": rng.normal(1, 0.2, C).astype(np.float32),
              "bias": rng.normal(0, 0.2, C).astype(np.float32)}
    stats = {"mean": rng.normal(0, 0.3, C).astype(np.float32),
             "var": rng.uniform(0.5, 1.5, C).astype(np.float32)}
    return params, stats


def port_bn(params, stats):
    bn = MaskedBatchNorm(len(params["scale"])).train()
    bn.load_state_dict({"weight": torch.from_numpy(params["scale"]),
                        "bias": torch.from_numpy(params["bias"]),
                        "running_mean": torch.from_numpy(stats["mean"]),
                        "running_var": torch.from_numpy(stats["var"]),
                        "num_batches_tracked": torch.tensor(0)})
    return bn


def port_bn_grads(bn, x, r, **kw):
    xt = torch.from_numpy(x).requires_grad_()
    y = bn(xt, **kw)
    (y * torch.from_numpy(r)).sum().backward()
    return (y.detach().numpy(), xt.grad.numpy(), bn.weight.grad.numpy(),
            bn.bias.grad.numpy())


def test_masked_batchnorm_pooled_matches_jax():
    rng = np.random.default_rng(0)
    N, C = 300, 16
    x = rng.normal(0.5, 2.0, (N, C)).astype(np.float32)
    valid = rng.random(N) < 0.7
    r = rng.normal(size=(N, C)).astype(np.float32)
    params, stats = bn_variables(rng, C)
    mod = JaxMaskedBN()

    def f(p, x):
        y, mut = mod.apply({"params": p, "batch_stats": stats}, x,
                           jnp.asarray(valid), train=True,
                           mutable=["batch_stats"])
        return jnp.sum(y * r), (y, mut["batch_stats"])
    (_, (jy, jstats)), (jgp, jgx) = jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True)(params, jnp.asarray(x))
    bn = port_bn(params, stats)
    y, gx, gw, gb = port_bn_grads(bn, x, r, valid=torch.from_numpy(valid))
    for g, w in ((y, jy), (gx, jgx), (gw, jgp["scale"]), (gb, jgp["bias"])):
        assert_close_of_max(g, np.asarray(w), "masked bn")
    np.testing.assert_allclose(bn.running_mean.numpy(), jstats["mean"],
                               atol=STAT_ATOL, rtol=0)
    np.testing.assert_allclose(bn.running_var.numpy(), jstats["var"],
                               atol=STAT_ATOL, rtol=0)


class _PerSampleJax(fnn.Module):
    """The JAX middle encoder's BatchNorm under nn.vmap over the batch."""

    @fnn.compact
    def __call__(self, x, valid):
        bn = fnn.vmap(JaxMaskedBN, in_axes=(0, 0, None), out_axes=0,
                      variable_axes={"params": None, "batch_stats": None},
                      split_rngs={"params": False}, axis_name="batch")(
            axis_name="batch", name="bn")
        return bn(x, valid, True)


def test_masked_batchnorm_per_sample_matches_jax_vmap():
    """B = 2 with 230 and 90 sites of different means: the per-sample
    statistics (each sample's mean and variance, averaged) are the JAX
    encoder's; statistics pooled over all sites are far from them."""
    rng = np.random.default_rng(1)
    C, cap = 8, 256
    counts = (230, 90)
    x = np.zeros((2, cap, C), np.float32)
    valid = np.zeros((2, cap), bool)
    for b, n in enumerate(counts):
        x[b, :n] = rng.normal(2.0 * b - 1.0, 1.0 + b, (n, C))
        valid[b, :n] = True
    # padding rows reach no loss, as in the encoder
    r = rng.normal(size=(2, cap, C)).astype(np.float32) * valid[..., None]
    params, stats = bn_variables(rng, C)
    mod = _PerSampleJax()

    def f(p, x):
        y, mut = mod.apply({"params": {"bn": p},
                            "batch_stats": {"bn": stats}},
                           x, jnp.asarray(valid), mutable=["batch_stats"])
        return jnp.sum(y * r), (y, mut["batch_stats"]["bn"])
    (_, (jy, jstats)), (jgp, jgx) = jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True)(params, jnp.asarray(x))
    rows = np.concatenate([x[b, :n] for b, n in enumerate(counts)])
    rr = np.concatenate([r[b, :n] for b, n in enumerate(counts)])
    sample = torch.cat([torch.full((n,), b) for b, n in enumerate(counts)])
    jy_rows = np.concatenate([np.asarray(jy)[b, :n]
                              for b, n in enumerate(counts)])
    jgx_rows = np.concatenate([np.asarray(jgx)[b, :n]
                               for b, n in enumerate(counts)])
    bn = port_bn(params, stats)
    y, gx, gw, gb = port_bn_grads(bn, rows, rr, sample=sample,
                                  num_samples=2)
    for g, w in ((y, jy_rows), (gx, jgx_rows), (gw, jgp["scale"]),
                 (gb, jgp["bias"])):
        assert_close_of_max(g, np.asarray(w), "per-sample bn")
    np.testing.assert_allclose(bn.running_mean.numpy(), jstats["mean"],
                               atol=STAT_ATOL, rtol=0)
    np.testing.assert_allclose(bn.running_var.numpy(), jstats["var"],
                               atol=STAT_ATOL, rtol=0)
    pooled = port_bn(params, stats)
    yp = port_bn_grads(pooled, rows, rr)[0]
    assert np.abs(yp - jy_rows).max() > 100 * BN_ATOL
    assert np.abs(pooled.running_var.numpy() - jstats["var"]).max() \
        > 100 * STAT_ATOL


def test_batchnorm2d_running_variance_is_flax_biased_one():
    rng = np.random.default_rng(3)
    B, C, H, W = 2, 6, 5, 5
    x = rng.normal(0.3, 1.5, (B, H, W, C)).astype(np.float32)
    params, stats = bn_variables(rng, C)
    mod = fnn.BatchNorm(use_running_average=False, momentum=0.99,
                        epsilon=1e-3)
    jy, mut = mod.apply({"params": params, "batch_stats": stats},
                        jnp.asarray(x), mutable=["batch_stats"])
    bn = BatchNorm2d(C, eps=1e-3, momentum=0.01).train()
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(params["scale"]))
        bn.bias.copy_(torch.from_numpy(params["bias"]))
        bn.running_mean.copy_(torch.from_numpy(stats["mean"]))
        bn.running_var.copy_(torch.from_numpy(stats["var"]))
    ref = torch.nn.BatchNorm2d(C, eps=1e-3, momentum=0.01).train()
    ref.load_state_dict(bn.state_dict())
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    y = bn(xt)
    ref(xt)
    np.testing.assert_allclose(y.detach().permute(0, 2, 3, 1).numpy(),
                               np.asarray(jy), atol=BN_ATOL, rtol=0)
    want = mut["batch_stats"]
    np.testing.assert_allclose(bn.running_mean.numpy(), want["mean"],
                               atol=STAT_ATOL, rtol=0)
    np.testing.assert_allclose(bn.running_var.numpy(), want["var"],
                               atol=STAT_ATOL, rtol=0)
    # torch's own BatchNorm2d takes the unbiased variance: (n / (n - 1))
    assert np.abs(ref.running_var.numpy() - want["var"]).max() \
        > 10 * STAT_ATOL
