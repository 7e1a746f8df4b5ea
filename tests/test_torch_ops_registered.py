"""Kernels K1 and K2 as `torch.library` custom operators
(`torch.ops.futuredet.nms_alive`, `torch.ops.futuredet.gather_conv`): fake
implementations, `opcheck` of the CPU implementations, the CPU operator
bit for bit the plain version (and K2's within fp32 summation order of the
JAX `loop` contraction), and `SparseConvFunction`'s gradients bit for bit
the formulas they had before the operators (dx through the flipped or
inverse table, the stacked dW, db = sum(dy), the bf16 dtype rules)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from futuredet_torch.ops import pallas_gather, pallas_nms
from futuredet_torch.ops.nms import rotate_nms_np
from futuredet_torch.ops.sparse_conv import (
    K_TAPS, downsample_coords, make_grid, neighbor_table, out_dims_of,
    strided_gather_table, strided_inverse_table, subm_conv_apply)
from futuredet_tpu.ops.sparse_conv import _gather_conv
from tests.test_torch_train_step import one_torch_thread  # noqa: F401

# K2's plain version against the JAX loop contraction: fp32 sums in
# another order
K2_RTOL = 1e-5


def sites(seed, n=300, dims=(6, 12, 12)):
    rng = np.random.default_rng(seed)
    lin = rng.choice(int(np.prod(dims)), n, replace=False)
    coords = np.stack([lin // (dims[1] * dims[2]),
                       (lin // dims[2]) % dims[1], lin % dims[2]], -1)
    return make_grid(torch.from_numpy(coords), dims)[0], dims


@pytest.fixture(scope="module")
def conv_case():
    """A submanifold table over 300 sites with absent neighbours, fp32
    inputs, and the JAX loop contraction of them."""
    grid, dims = sites(0)
    table = neighbor_table(grid, dims)
    rng = np.random.default_rng(1)
    x = rng.normal(size=(len(grid.ids), 16)).astype(np.float32)
    w = (rng.normal(size=(K_TAPS, 16, 32)) / 20).astype(np.float32)
    b = rng.normal(size=32).astype(np.float32)
    want = np.asarray(_gather_conv(jnp.asarray(x), jnp.asarray(table),
                                   jnp.asarray(w), jnp.asarray(b), None,
                                   "loop"))
    return (torch.from_numpy(x), table, torch.from_numpy(w),
            torch.from_numpy(b)), want


def test_the_operators_exist_with_fake_implementations():
    ops = torch.ops.futuredet
    assert {"nms_alive", "gather_conv"} <= set(dir(ops))
    with FakeTensorMode():
        alive = ops.nms_alive(torch.empty(7, 1000, 5),
                              torch.empty(7, 1000, dtype=torch.bool), 0.2)
        out = ops.gather_conv(torch.empty(50, 16), torch.empty(
            27, 40, dtype=torch.int32), torch.empty(27, 16, 64), None)
        out16 = ops.gather_conv(
            torch.empty(50, 5, dtype=torch.bfloat16),
            torch.empty(27, 9, dtype=torch.int32),
            torch.empty(27, 5, 8, dtype=torch.bfloat16), torch.empty(8))
    assert alive.shape == (7, 1000) and alive.dtype == torch.bool
    assert out.shape == (40, 64) and out.dtype == torch.float32
    assert out16.shape == (9, 8) and out16.dtype == torch.float32


def test_opcheck_on_the_cpu(conv_case):
    (x, t, w, b), _ = conv_case
    for args in ((x, t, w, b), (x, t, w, None),
                 (x.double(), t, w.double(), b.double()),
                 (x.bfloat16(), t, w.bfloat16(), b)):
        torch.library.opcheck(torch.ops.futuredet.gather_conv.default, args)
    boxes = torch.rand(3, 70, 5) * torch.tensor([20, 20, 4, 4, 6])
    valid = torch.rand(3, 70) < 0.9
    torch.library.opcheck(torch.ops.futuredet.nms_alive.default,
                          (boxes, valid, 0.2))


def test_cpu_operators_are_the_plain_versions(conv_case):
    (x, t, w, b), want = conv_case
    before = (pallas_gather.gather_conv.launches,
              pallas_nms.rotate_nms_alive.launches)
    got = pallas_gather.gather_conv(x, t, w, b)
    assert torch.equal(got, pallas_gather.gather_conv_plain(x, t, w, b))
    assert torch.equal(torch.ops.futuredet.gather_conv(x, t, w, b), got)
    tol = K2_RTOL * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got.numpy(), want, atol=tol, rtol=0)
    rng = np.random.default_rng(2)
    boxes = np.zeros((1, 120, 7), np.float32)
    boxes[0, :, :2] = rng.uniform(-12, 12, (120, 2))
    boxes[0, :, 3:6] = rng.uniform(1, 4, (120, 3))
    boxes[0, :, 6] = rng.uniform(-np.pi, np.pi, 120)
    nb = torch.from_numpy(np.stack(
        [boxes[0, :, 0], boxes[0, :, 1], boxes[0, :, 4], boxes[0, :, 3],
         -boxes[0, :, 6] - np.pi / 2], -1)[None].astype(np.float32))
    valid = torch.ones(1, 120, dtype=torch.bool)
    alive = pallas_nms.rotate_nms_alive(nb, valid, 0.1)
    assert torch.equal(alive, pallas_nms.nms_alive_plain(nb, valid, 0.1))
    # the boxes come score-sorted: the numpy oracle keeps the same ones
    keep = rotate_nms_np(boxes[0], -np.arange(120, dtype=np.float32), 0.1,
                         pre_max=120, post_max=120)
    assert 20 < len(keep) < 120
    np.testing.assert_array_equal(np.flatnonzero(alive[0].numpy()),
                                  np.sort(keep))
    assert (pallas_gather.gather_conv.launches,
            pallas_nms.rotate_nms_alive.launches) == before


def k2_dx_formula(dy, table, weights, inverse):
    """The input gradient as ops/sparse_conv.py wrote it before the
    operators: one plain gather-conv over the same table with flipped,
    transposed weights, or over the inverse table with transposed ones."""
    if inverse is None:
        w = torch.flip(weights, (0,)).transpose(1, 2).contiguous()
        return pallas_gather.gather_conv_plain(dy, table, w)
    return pallas_gather.gather_conv_plain(
        dy, inverse, weights.transpose(1, 2).contiguous())


def dw_formula(features, table, dy):
    cin = features.shape[1]
    padded = torch.cat([features, features.new_zeros(1, cin)])
    g = padded.index_select(0, table.t().reshape(-1))
    g = g.view(table.shape[1], K_TAPS * cin)
    return (g.t() @ dy).view(K_TAPS, cin, dy.shape[1])


@pytest.mark.parametrize("kind", ["subm", "strided"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sparse_conv_gradients_keep_their_formulas(kind, dtype):
    grid, dims = sites(3)
    if kind == "subm":
        table, inverse = neighbor_table(grid, dims), None
    else:
        out_dims = out_dims_of(dims, (1, 1, 1))
        out = downsample_coords(grid, out_dims)
        table = strided_gather_table(grid, out, dims)
        inverse = strided_inverse_table(grid, out, out_dims)
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.normal(size=(len(grid.ids), 16)).astype(
        np.float32)).to(dtype).requires_grad_()
    w = torch.from_numpy((rng.normal(size=(K_TAPS, 16, 32)) / 20).astype(
        np.float32)).requires_grad_()
    b = torch.from_numpy(rng.normal(size=32).astype(np.float32)
                         ).requires_grad_()
    y = subm_conv_apply(x, table, w, b, inverse)
    dy = torch.from_numpy(rng.normal(size=tuple(y.shape)).astype(
        np.float32))
    y.backward(dy)
    assert y.dtype == torch.float32
    assert x.grad.dtype == dtype and w.grad.dtype == torch.float32
    assert torch.equal(x.grad, k2_dx_formula(dy, table, w.detach(),
                                             inverse).to(dtype))
    assert torch.equal(w.grad, dw_formula(x.detach().float(), table, dy))
    assert torch.equal(b.grad, dy.sum(0))


def test_the_circle_nms_operator():
    """The circle NMS as `torch.ops.futuredet.circle_nms`: its fake
    implementation's (post_max,) int64 selection and scalar count,
    `opcheck` on the CPU, and the selection of `ops/nms.py::circle_nms`
    equal to a sequential greedy walk's over the valid scores."""
    from futuredet_torch.ops.nms import circle_nms
    ops = torch.ops.futuredet
    assert "circle_nms" in set(dir(ops))
    with FakeTensorMode():
        sel, count = ops.circle_nms(torch.empty(500, 2), torch.empty(500),
                                    torch.empty(500, dtype=torch.bool),
                                    1.0, 83)
    assert sel.shape == (83,) and sel.dtype == torch.int64
    assert count.shape == () and count.dtype == torch.int64
    rng = np.random.default_rng(3)
    centers = torch.from_numpy(rng.uniform(-6, 6, (120, 2)).astype(
        np.float32))
    scores = torch.from_numpy(rng.uniform(0, 1, 120).astype(np.float32))
    valid = torch.from_numpy(rng.uniform(0, 1, 120) < 0.8)
    torch.library.opcheck(ops.circle_nms.default,
                          (centers, scores, valid, 1.5, 20))
    sel, count = circle_nms(centers, scores, valid, min_radius=1.5,
                            post_max=20)
    c, s, v = centers.numpy(), scores.numpy(), valid.numpy()
    keep = []
    for i in np.argsort(-np.where(v, s, -np.inf), kind="stable"):
        if v[i] and all(((c[i] - c[k]) ** 2).sum() > 1.5 for k in keep):
            keep.append(i)
    assert int(count) == min(len(keep), 20) == 20
    assert sel.tolist() == keep[:20]
