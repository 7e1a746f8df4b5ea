"""futuredet_torch/ops/deform.py against futuredet_tpu/ops/deform.py on the
same numpy-seeded inputs (1e-5): bilinear_sample inside, between and
outside the image, deform_conv2d at zero, fractional and out-of-image
offsets, zero offsets as a plain conv, and the gradients into the input,
the offsets and the weights against jax.grad."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from futuredet_tpu.ops.deform import bilinear_sample as jax_sample
from futuredet_tpu.ops.deform import deform_conv2d as jax_deform
from futuredet_torch.ops.deform import bilinear_sample, deform_conv2d
from tests.test_torch_train_step import one_torch_thread  # noqa: F401

TOL = 1e-5
B, H, W, CIN, COUT, G = 2, 7, 9, 8, 6, 4


def inputs(kind, seed=0):
    """x (B, H, W, Cin), offsets (B, H, W, G*18), weights (9, Cin, Cout)
    in the JAX layouts."""
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (B, H, W, CIN)).astype(np.float32)
    w = rng.normal(0, 0.3, (9, CIN, COUT)).astype(np.float32)
    if kind == "zero":
        off = np.zeros((B, H, W, G * 18), np.float32)
    elif kind == "fractional":
        off = rng.uniform(-0.9, 0.9, (B, H, W, G * 18)).astype(np.float32)
    else:       # most taps land off the image; pixel (0, 0) of sample 0
        off = rng.uniform(-6.0, 6.0, (B, H, W, G * 18)).astype(np.float32)
        off[0, 0, 0] = 20.0         # has every tap outside it
    return x, off, w


def port_layout(x, off, w):
    """The same operands in the port's NCHW / (Cout, Cin, 3, 3) layouts."""
    return (torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(),
            torch.from_numpy(off).permute(0, 3, 1, 2).contiguous(),
            torch.from_numpy(np.ascontiguousarray(
                np.transpose(w, (2, 1, 0)).reshape(COUT, CIN, 3, 3))))


def test_bilinear_sample_matches_jax():
    rng = np.random.default_rng(1)
    img = rng.normal(0, 1, (H, W, 3)).astype(np.float32)
    # inside, on the grid, between cells, on and past every edge
    ys = np.concatenate([rng.uniform(-2, H + 1, 40), [0, H - 1, H - 0.5,
                                                      -0.5, -1, -5.0]])
    xs = np.concatenate([rng.uniform(-2, W + 1, 40), [0, W - 1, -0.5,
                                                      W - 0.5, 4.0, -5.0]])
    ys, xs = ys.astype(np.float32), xs.astype(np.float32)
    want = np.asarray(jax_sample(jnp.asarray(img), jnp.asarray(ys),
                                 jnp.asarray(xs)))
    got = bilinear_sample(torch.from_numpy(img), torch.from_numpy(ys),
                          torch.from_numpy(xs)).numpy()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(got[40], img[0, 0], atol=TOL)
    assert np.all(got[-1] == 0)


@pytest.mark.parametrize("kind", ["zero", "fractional", "out_of_image"])
def test_deform_conv2d_matches_jax(kind):
    x, off, w = inputs(kind)
    want = np.asarray(jax_deform(jnp.asarray(x), jnp.asarray(off),
                                 jnp.asarray(w), deformable_groups=G))
    got = deform_conv2d(*port_layout(x, off, w), deformable_groups=G)
    assert got.shape == (B, COUT, H, W)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               atol=TOL, rtol=TOL)
    if kind == "out_of_image":
        assert np.all(want[0, 0, 0] == 0) and np.all(
            got[0, :, 0, 0].numpy() == 0)


def test_zero_offsets_are_a_plain_conv():
    x, off, w = inputs("zero", seed=3)
    tx, toff, tw = port_layout(x, off, w)
    np.testing.assert_allclose(
        deform_conv2d(tx, toff, tw, deformable_groups=G).numpy(),
        F.conv2d(tx, tw, padding=1).numpy(), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("kind", ["fractional", "out_of_image"])
def test_gradients_match_jax(kind):
    x, off, w = inputs(kind, seed=5)
    rng = np.random.default_rng(6)
    dy = rng.normal(0, 1, (B, H, W, COUT)).astype(np.float32)

    def f(x_, off_, w_):
        return jnp.sum(jax_deform(x_, off_, w_, deformable_groups=G)
                       * jnp.asarray(dy))
    want = jax.grad(f, argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(off),
                                          jnp.asarray(w))
    tx, toff, tw = (t.requires_grad_() for t in port_layout(x, off, w))
    out = deform_conv2d(tx, toff, tw, deformable_groups=G)
    (out * torch.from_numpy(dy).permute(0, 3, 1, 2)).sum().backward()
    np.testing.assert_allclose(tx.grad.permute(0, 2, 3, 1).numpy(),
                               np.asarray(want[0]), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(toff.grad.permute(0, 2, 3, 1).numpy(),
                               np.asarray(want[1]), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(
        tw.grad.numpy(), np.transpose(np.asarray(want[2]), (2, 1, 0))
        .reshape(COUT, CIN, 3, 3), atol=TOL, rtol=TOL)
    assert np.abs(np.asarray(want[1])).max() > 0
