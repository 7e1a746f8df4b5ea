"""The backward of futuredet_torch's bf16 layers against the JAX
package's, one layer at a time:

  * `SparseConvFunction` under bf16 features (the sparse middle under
    `middle_sparse_dtype="bfloat16"`) against `jax.vjp` of the JAX custom
    VJPs `_subm_conv_sym_vjp` and `_strided_conv_vjp` on the same tables:
    dx is an fp32 gather-conv of the fp32 cotangent with the fp32 weights,
    rounded to bf16, so it equals the JAX dx but where the two fp32 sums,
    taken in another order, round to neighbouring bf16 values (DX_EQUAL of
    the entries at least, the rest one bf16 ulp apart); dW is fp32, within
    DW_RTOL of max |dW|. Rounding W to bf16 before the Function (the
    forward alone cannot tell) fails both;
  * the dense middle's bf16 conv (`middle_dense_dtype`,
    `SparseConv.dense`): `jax.grad` of the JAX `DenseConv3d(compute_dtype=
    bf16)` raises (the transpose of `conv_general_dilated` meets an fp32
    cotangent and a bf16 operand); the port's d(canvas) and dW are those
    of jax.grad of the same forward as an fp32 conv of the rounded
    operands: fp32 sums, each gradient rounded to bf16 on its way back
    through its operand's rounding, as JAX's rule for a mixed-precision
    product gives. Gradients left in fp32 fail;
  * the head's towers under `compute_dtype` in train mode, the port's
    SepHead against the JAX SepHead with its per-branch towers: output,
    every gradient and the running statistics within GAP_FRACTION of the
    JAX layer's own bf16-vs-fp32 distance (one layer rounds alike on both
    sides), and the two findings that set the whole-step tests' reference
    (tests/test_torch_train_bf16_pillars.py): the JAX fused towers sum the
    cotangent of their bf16 normalisation over the batch in bf16 on
    XLA:CPU, so their BatchNorm gradients stand far from the per-branch
    towers'; and a bf16 bias's JAX gradient is that bf16 sum, 256 for 2048
    ones, where the port's is 2048."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from futuredet_tpu.models.center_head import SepHead as JaxSepHead
from futuredet_tpu.models.middle import DenseConv3d
from futuredet_tpu.ops.sparse_conv import (_strided_conv_vjp,
                                           _subm_conv_sym_vjp)
from futuredet_torch.models.center_head import SepHead
from futuredet_torch.models.layers import Conv2d
from futuredet_torch.models.middle import SparseConv
from futuredet_torch.ops.pallas_gather import gather_conv_plain
from futuredet_torch.ops.sparse_conv import (SparseConvFunction,
                                             downsample_coords,
                                             neighbor_table, out_dims_of,
                                             strided_gather_table,
                                             strided_inverse_table)
from tests.test_torch_bf16 import _sites

DX_EQUAL = 0.995
DW_RTOL = 1e-5
GAP_FRACTION = 0.25
BF16_ULP = 2.0 ** -7          # of a value in [1, 2): one bf16 step


def _ulps_apart(got, want):
    """|got - want| in bf16 ulps of want (both bf16-valued)."""
    got, want = (np.asarray(t, np.float64) for t in (got, want))
    step = np.exp2(np.floor(np.log2(np.maximum(np.abs(want), 1e-30)))) \
        * BF16_ULP
    return np.abs(got - want) / step


def _check_dx_dw(dx, dw, jdx, jdw):
    """The module docstring's dx / dW rule: (bool, why)."""
    dx = dx.float().numpy()
    jdx = np.asarray(jnp.asarray(jdx).astype(jnp.float32))
    equal = float(np.mean(dx == jdx))
    if equal < DX_EQUAL or _ulps_apart(dx, jdx).max() > 1:
        return False, f"dx: {equal:.4f} equal"
    jdw = np.asarray(jdw)
    err = float(np.abs(dw.numpy() - jdw).max())
    if dw.dtype != torch.float32 or err > DW_RTOL * np.abs(jdw).max():
        return False, f"dW {dw.dtype} off by {err:.3g}"
    return True, ""


def _conv_case(kind, cin, cout=32, seed=0):
    grid, dims = _sites(cin + (kind == "strided"))
    rng = np.random.default_rng(seed)
    inv = None
    if kind == "subm":
        table = neighbor_table(grid, dims)
    else:
        pads = (1, 1, 1)
        out_dims = out_dims_of(dims, pads)
        out = downsample_coords(grid, out_dims, pads)
        table = strided_gather_table(grid, out, dims, pads=pads)
        inv = strided_inverse_table(grid, out, out_dims, pads=pads)
    x = rng.normal(size=(len(grid.ids), cin)).astype(np.float32)
    w = (rng.normal(size=(27, cin, cout)) / np.sqrt(27 * cin)).astype(
        np.float32)
    b = rng.normal(0, 0.1, cout).astype(np.float32)
    gy = rng.normal(size=(table.shape[1], cout)).astype(np.float32)
    return x, w, b, gy, table, inv


def _jax_vjp(x, w, b, gy, table, inv):
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    tab = jnp.asarray(table.numpy())
    if inv is None:
        fn = lambda x, w, b: _subm_conv_sym_vjp(  # noqa: E731
            x, tab, w, b, None, "loop")
    else:
        itab = jnp.asarray(inv.numpy())
        fn = lambda x, w, b: _strided_conv_vjp(  # noqa: E731
            x, tab, itab, w, b, None, "loop")
    _, vjp = jax.vjp(fn, xb, jnp.asarray(w), jnp.asarray(b))
    return vjp(jnp.asarray(gy))


def _port_grads(x, w, b, gy, table, inv, round_w_first=False):
    xb = torch.from_numpy(x).bfloat16().requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    bt = torch.from_numpy(b).requires_grad_()
    if round_w_first:
        # the forward is the Function's; autograd of its plain version
        # with the weights rounded outside
        out = gather_conv_plain(xb, table, wt.to(torch.bfloat16), bt)
    else:
        out = SparseConvFunction.apply(xb, table, wt, bt, inv)
    out.backward(torch.from_numpy(gy))
    return out, xb.grad, wt.grad, bt.grad


@pytest.mark.parametrize("kind,cin", [("subm", 16), ("subm", 64),
                                      ("strided", 16), ("strided", 32)])
def test_sparse_conv_function_bf16_grads_are_the_jax_vjps(kind, cin):
    x, w, b, gy, table, inv = _conv_case(kind, cin)
    jdx, jdw, jdb = _jax_vjp(x, w, b, gy, table, inv)
    out, dx, dw, db = _port_grads(x, w, b, gy, table, inv)
    assert dx.dtype == torch.bfloat16 and jdx.dtype == jnp.bfloat16
    ok, why = _check_dx_dw(dx, dw, jdx, jdw)
    assert ok, why
    np.testing.assert_allclose(db.numpy(), np.asarray(jdb), rtol=1e-5,
                               atol=1e-5)
    # the forward is K2's bf16 mode (bf16 x and W)
    assert out.dtype == torch.float32
    # the rounding of dx is real: an fp32 dx would not be bf16-valued
    assert float(np.mean(dx.float().numpy()
                         == np.asarray(jdx, np.float32))) >= DX_EQUAL


@pytest.mark.parametrize("kind,cin", [("subm", 16), ("strided", 32)])
def test_weights_rounded_before_the_function_fail_the_vjp_test(kind, cin):
    """The backward that rounds W to bf16 outside the Function (dx over
    bf16 weights, dW rounded to bf16) gives the same forward and fails."""
    x, w, b, gy, table, inv = _conv_case(kind, cin)
    jdx, jdw, _ = _jax_vjp(x, w, b, gy, table, inv)
    out, dx, dw, _ = _port_grads(x, w, b, gy, table, inv,
                                 round_w_first=True)
    ref = _port_grads(x, w, b, gy, table, inv)[0]
    assert torch.allclose(out, ref, rtol=1e-5, atol=1e-5)
    ok, why = _check_dx_dw(dx, dw, jdx, jdw)
    assert not ok, "a backward on bf16 weights passed"
    # both halves fail on their own
    assert float(np.mean(dx.float().numpy()
                         == np.asarray(jdx, np.float32))) < DX_EQUAL
    assert float(np.abs(dw.numpy() - np.asarray(jdw)).max()) \
        > DW_RTOL * np.abs(np.asarray(jdw)).max()


# ------------------------------------------------------------- dense conv

def _dense_case(stride, seed=3):
    rng = np.random.default_rng(seed)
    canvas = rng.normal(size=(5, 6, 7, 8)).astype(np.float32)
    cout = 16
    w = (rng.normal(size=(27, 8, cout)) / np.sqrt(27 * 8)).astype(np.float32)
    b = rng.normal(0, 0.1, cout).astype(np.float32)
    out_shape = tuple((d + 2 - 3) // stride + 1 for d in canvas.shape[:3])
    gy = rng.normal(size=out_shape + (cout,)).astype(np.float32)
    return canvas, w, b, gy


def _dense_jax_grads(canvas, w, b, gy, stride):
    """jax.grad of DenseConv3d's forward written as an fp32 conv of the
    bf16-rounded operands."""
    def f(c, w, b):
        y = jax.lax.conv_general_dilated(
            c.astype(jnp.bfloat16).astype(jnp.float32)[None],
            w.reshape(3, 3, 3, 8, -1).astype(jnp.bfloat16).astype(
                jnp.float32), (stride,) * 3, [(1, 1)] * 3,
            dimension_numbers=("NDHWC", "DHWIO", "NDHWC"),
            precision=jax.lax.Precision.HIGHEST)[0] + b
        return jnp.sum(y * gy)
    return jax.grad(f, argnums=(0, 1, 2))(jnp.asarray(canvas),
                                          jnp.asarray(w), jnp.asarray(b))


def _dense_port(canvas, w, b, stride, dtype=torch.bfloat16):
    conv = SparseConv(8, 16)
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(w).reshape(3, 3, 3, 8, 16))
        conv.bias.copy_(torch.from_numpy(b))
    c = torch.from_numpy(canvas).permute(3, 0, 1, 2)[None].requires_grad_()
    y = conv.dense(c, stride, dtype=dtype)
    return conv, c, y


@pytest.mark.parametrize("stride", [1, 2])
def test_dense_bf16_conv_grads(stride):
    canvas, w, b, gy = _dense_case(stride)
    m = DenseConv3d(16, stride=stride, compute_dtype=jnp.bfloat16)
    params = {"params": {"kernel": jnp.asarray(w), "bias": jnp.asarray(b)}}
    # the JAX layer has no gradient under its compute dtype
    with pytest.raises(TypeError, match="same dtypes"):
        jax.grad(lambda p, c: jnp.sum(m.apply(p, c)), argnums=(0, 1))(
            params, jnp.asarray(canvas))
    want_y = np.asarray(m.apply(params, jnp.asarray(canvas)))
    jdc, jdw, jdb = _dense_jax_grads(canvas, w, b, gy, stride)

    conv, c, y = _dense_port(canvas, w, b, stride)
    np.testing.assert_allclose(y[0].permute(1, 2, 3, 0).detach().numpy(),
                               want_y, rtol=1e-5, atol=1e-5)
    (y[0].permute(1, 2, 3, 0) * torch.from_numpy(gy)).sum().backward()
    dc = c.grad[0].permute(1, 2, 3, 0).numpy()
    dw = conv.weight.grad.reshape(27, 8, 16).numpy()
    for got, want in ((dc, jdc), (dw, jdw)):
        want = np.asarray(want)
        # both gradients are bf16 values: rounded on the way back
        assert np.array_equal(got, np.asarray(
            jnp.asarray(got).astype(jnp.bfloat16).astype(jnp.float32)))
        assert float(np.mean(got == want)) >= DX_EQUAL
        assert _ulps_apart(got, want).max() <= 1
    np.testing.assert_allclose(conv.bias.grad.numpy(), np.asarray(jdb),
                               rtol=1e-5, atol=1e-4)


def test_dense_fp32_gradients_fail_the_dense_test():
    """Gradients that skip the rounding on the way back (a straight-through
    bf16 conv) are not JAX's."""
    canvas, w, b, gy = _dense_case(1)
    jdc, jdw, _ = _dense_jax_grads(canvas, w, b, gy, 1)
    conv, c, y = _dense_port(canvas, w, b, 1, dtype=None)
    (y[0].permute(1, 2, 3, 0) * torch.from_numpy(gy)).sum().backward()
    dc = c.grad[0].permute(1, 2, 3, 0).numpy()
    assert float(np.mean(dc == np.asarray(jdc))) < DX_EQUAL


# ----------------------------------------------------------------- towers

HEADS = (("reg", (2, 2)), ("height", (1, 2)), ("hm", (1, 2)))


def _jax_head(dt, fuse):
    return JaxSepHead(heads=HEADS, head_conv=16, in_channels=16,
                      compute_dtype=dt, fuse_branches=fuse)


def _jax_run(fuse, dt, variables, x, proj):
    m = _jax_head(dt, fuse)

    def f(params):
        out, mut = m.apply({"params": params,
                            "batch_stats": variables["batch_stats"]},
                           x, train=True, mutable=["batch_stats"])
        s = sum(jnp.sum(out[h].astype(jnp.float32) * proj[h])
                for h, _ in HEADS)
        return s, (out, mut["batch_stats"])
    (_, (out, stats)), grads = jax.value_and_grad(f, has_aux=True)(
        variables["params"])
    return jax.device_get((out, grads, stats))


def _port_head(variables, dt):
    m = SepHead(16, HEADS, head_conv=16, compute_dtype=dt).train()
    p, s = variables["params"], variables["batch_stats"]
    sd = {}
    for h, _ in HEADS:
        k = np.asarray(p[f"{h}_conv0"]["kernel"])
        sd[f"{h}.0.weight"] = np.transpose(k, (3, 2, 0, 1))
        sd[f"{h}.0.bias"] = np.asarray(p[f"{h}_conv0"]["bias"])
        sd[f"{h}.1.weight"] = np.asarray(p[f"{h}_bn0"]["scale"])
        sd[f"{h}.1.bias"] = np.asarray(p[f"{h}_bn0"]["bias"])
        sd[f"{h}.1.running_mean"] = np.asarray(s[f"{h}_bn0"]["mean"])
        sd[f"{h}.1.running_var"] = np.asarray(s[f"{h}_bn0"]["var"])
        k = np.asarray(p[f"{h}_final"]["kernel"])
        sd[f"{h}.3.weight"] = np.transpose(k, (3, 2, 0, 1))
        sd[f"{h}.3.bias"] = np.asarray(p[f"{h}_final"]["bias"])
    m.load_state_dict({k: torch.from_numpy(np.ascontiguousarray(v))
                       for k, v in sd.items()}, strict=False)
    return m


def _to_port_names(grads, stats):
    out = {}
    for h, _ in HEADS:
        out[f"{h}.0.weight"] = np.transpose(grads[f"{h}_conv0"]["kernel"],
                                            (3, 2, 0, 1))
        out[f"{h}.0.bias"] = grads[f"{h}_conv0"]["bias"]
        out[f"{h}.1.weight"] = grads[f"{h}_bn0"]["scale"]
        out[f"{h}.1.bias"] = grads[f"{h}_bn0"]["bias"]
        out[f"{h}.3.weight"] = np.transpose(grads[f"{h}_final"]["kernel"],
                                            (3, 2, 0, 1))
        out[f"{h}.3.bias"] = grads[f"{h}_final"]["bias"]
        out[f"{h}.1.running_mean"] = stats[f"{h}_bn0"]["mean"]
        out[f"{h}.1.running_var"] = stats[f"{h}_bn0"]["var"]
    return {k: np.asarray(v, np.float64) for k, v in out.items()}


@pytest.fixture(scope="module")
def towers():
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 8, 8, 16)).astype(np.float32)
    m = _jax_head(None, False)
    variables = jax.device_get(m.init(jax.random.PRNGKey(0), x, train=True))
    variables = jax.tree_util.tree_map_with_path(
        lambda path, v: (np.asarray(v) + 3.0 if getattr(path[-1], "key", "")
                         == "bias" and "_bn" in getattr(path[-2], "key", "")
                         else np.asarray(v)), variables)
    proj = {h: rng.normal(size=(2, 8, 8, c)).astype(np.float32)
            for h, (c, _) in HEADS}
    runs = {(fuse, dt): _jax_run(fuse, dt, variables, x, proj)
            for fuse in (False, True) for dt in (None, "bfloat16")}
    port = {}
    for dt in (None, torch.bfloat16):
        m = _port_head(variables, dt)
        out = m(torch.from_numpy(x).permute(0, 3, 1, 2))
        s = sum((out[h].permute(0, 2, 3, 1) * torch.from_numpy(proj[h]))
                .sum() for h, _ in HEADS)
        s.backward()
        g = {n: p.grad.double().numpy() for n, p in m.named_parameters()}
        g.update({n: b.double().numpy() for n, b in m.named_buffers()
                  if n.endswith(("running_mean", "running_var"))})
        port[dt] = ({h: out[h].permute(0, 2, 3, 1).double().detach()
                     .numpy() for h, _ in HEADS}, g)
    return runs, port


def test_port_towers_match_the_jax_per_branch_towers_in_bf16(towers):
    """Every output equal but for rounding, every gradient (the conv
    biases aside: their JAX gradients are bf16 sums, the last test) and
    running statistic within a quarter of the JAX layer's bf16-vs-fp32
    distance; the port in fp32 fails each."""
    runs, port = towers
    jb_out, jb_g, jb_s = runs[(False, "bfloat16")]
    jf_out, jf_g, jf_s = runs[(False, None)]
    jb = _to_port_names(jb_g, jb_s)
    jf = _to_port_names(jf_g, jf_s)
    pb_out, pb = port[torch.bfloat16]
    pf_out, pf = port[None]
    for h, _ in HEADS:
        # bf16 outputs: equal, or one ulp apart where two fp32 sums round
        # to neighbours
        want = np.asarray(jb_out[h], np.float64)
        assert float(np.mean(pb_out[h] == want)) >= DX_EQUAL, h
        assert _ulps_apart(pb_out[h], want).max() <= 1, h
        assert float(np.mean(pf_out[h] == want)) < DX_EQUAL, h
    held = [n for n in jb if not n.endswith((".0.bias", ".3.bias"))]
    for n in held:
        gap = np.abs(jf[n] - jb[n]).max()
        err = np.abs(pb[n] - jb[n]).max()
        assert gap > 0 and err <= GAP_FRACTION * gap, (n, err, gap)
        assert np.abs(pf[n] - jb[n]).max() > GAP_FRACTION * gap, n


def test_jax_fused_towers_sum_their_bf16_cotangents_in_bf16(towers):
    """The fused towers' BatchNorm gradients under bf16 stand far from the
    per-branch towers' (which the port's match), though the two are one
    function in fp32."""
    runs, _ = towers
    unf = _to_port_names(*runs[(False, "bfloat16")][1:])
    fus = _to_port_names(*runs[(True, "bfloat16")][1:])
    f32 = _to_port_names(*runs[(False, None)][1:])
    f32_fused = _to_port_names(*runs[(True, None)][1:])
    bn = [n for n in unf if n.endswith(".1.bias")]
    for n in bn:
        np.testing.assert_allclose(f32_fused[n], f32[n], rtol=1e-4,
                                   atol=1e-4)
    worst = max(np.abs(fus[n] - unf[n]).max() / np.abs(unf[n]).max()
                for n in bn)
    assert worst > 0.05


def test_jax_bf16_bias_gradient_is_a_bf16_sum():
    """XLA:CPU sums the cotangent of a bf16 bias over the batch in bf16:
    2048 ones give 256. The port's bf16 conv sums it in fp32."""
    def f(b):
        y = jnp.ones((2, 32, 32, 4), jnp.bfloat16) + b.astype(jnp.bfloat16)
        return jnp.sum(y.astype(jnp.float32))
    np.testing.assert_array_equal(np.asarray(jax.grad(f)(jnp.zeros(4))),
                                  [256.0] * 4)
    conv = Conv2d(4, 4, 1, compute_dtype=torch.bfloat16)
    with torch.no_grad():
        conv.weight.zero_()
    conv(torch.zeros(2, 4, 32, 32)).float().sum().backward()
    np.testing.assert_array_equal(conv.bias.grad.numpy(), [2048.0] * 4)
