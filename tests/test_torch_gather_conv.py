"""K2's two families, on the CPU: which family takes each conv, and why the
wide family's tensor-core arithmetic is 3xTF32 and not plain TF32.

The wide family (csrc/gather_conv_kernel.cu) multiplies on the tensor cores
in TF32, which keeps 10 of fp32's 23 mantissa bits. It splits each operand
into hi = rna(x) and lo = rna(x - hi) and sums lo*hi + hi*lo + hi*hi in
fp32. The emulation below repeats that arithmetic in numpy at the stage-3
width (27 taps x 128 channels deep, 55% of the rows absent, 128 outputs)
and holds it to K2's tolerance against its plain fp32 version: 1e-5 of
max(1, max|plain|). 3xTF32 stays inside it (~4e-7); one TF32 product per
pair does not (~3e-4), which is why the kernel pays three MMAs per
fragment instead of one.
"""
import numpy as np
import pytest
import torch

from futuredet_torch.ops.pallas_gather import (COUTS, gather_conv,
                                               gather_conv_plain, k2_route)

K2_RTOL = 1e-5   # K2 vs plain: of max(1, max|plain|), as chip_smoke.py


@pytest.mark.parametrize("cin,cout,route", [
    # the 20 convs of forecast_n3dtf's sparse middle encoder
    (5, 16, "narrow"),      # conv_input
    (16, 16, "narrow"),     # stage-0 block convs
    (16, 32, "narrow"),     # down1
    (32, 32, "wide"),       # stage-1 block convs
    (32, 64, "wide"),       # down2
    (64, 64, "wide"),       # stage-2 block convs
    (64, 128, "wide"),      # down3
    (128, 128, "wide"),     # stage-3 block convs
    # edges
    (1, 8, "narrow"), (5, 32, "narrow"), (16, 8, "narrow"),
    (16, 64, "wide"), (16, 128, "wide"), (8, 64, "wide"),
    (32, 8, "wide"), (32, 16, "wide"), (20, 16, "wide"), (36, 128, "wide"),
])
def test_k2_route_per_width(cin, cout, route):
    assert k2_route(cin, cout) == route


@pytest.mark.parametrize("cin,cout", [
    (5, 64), (17, 32), (33, 64), (16, 24), (128, 256), (0, 16)])
def test_k2_route_refuses_what_no_family_takes(cin, cout):
    """Cout outside the instantiated widths, or Cin too wide for the narrow
    family and not a multiple of 4 for the wide one's 16-byte copies."""
    with pytest.raises(ValueError, match="K2 takes"):
        k2_route(cin, cout)


def test_k2_routes_cover_every_instantiated_width():
    for cout in COUTS:
        assert k2_route(16, cout) == ("narrow" if cout <= 32 else "wide")
        assert k2_route(128, cout) == "wide"


def test_wrapper_checks_device_before_building_and_counts_no_cpu_call():
    """A tensor neither on the CPU nor on a card is refused before the
    wrapper would need nvcc; on the CPU every shape, even one no family
    takes, goes to the plain version and launches nothing."""
    tab = torch.zeros(27, 3, dtype=torch.int32)
    with pytest.raises(ValueError, match="unsupported device"):
        gather_conv(torch.zeros(10, 32, device="meta"), tab.to("meta"),
                    torch.zeros(27, 32, 32, device="meta"))
    before = gather_conv.launches
    x, w = torch.ones(10, 17), torch.ones(27, 17, 24)
    torch.testing.assert_close(gather_conv(x, tab, w),
                               gather_conv_plain(x, tab, w))
    assert gather_conv.launches == before


def tf32_rna(a: np.ndarray) -> np.ndarray:
    """fp32 -> TF32 (10-bit mantissa), rounding to nearest, ties away from
    zero, as `cvt.rna.tf32.f32`; returned as fp32."""
    bits = np.ascontiguousarray(a, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(
        np.float32)


def emulate_wide(x, table, w, split):
    """The wide family's sum: per tap, the gathered rows (zero where absent)
    times W[k], each product in TF32 operands with fp32 sums; `split`
    picks 3xTF32 (lo*hi + hi*lo + hi*hi) or one TF32 product (hi*hi)."""
    V = x.shape[0]
    padded = np.concatenate([x, np.zeros((1, x.shape[1]), np.float32)])
    out = np.zeros((table.shape[1], w.shape[2]), np.float32)
    for k in range(table.shape[0]):
        a = padded[np.where(table[k] < V, table[k], V)]
        ah, bh = tf32_rna(a), tf32_rna(w[k])
        if split:
            al, bl = tf32_rna(a - ah), tf32_rna(w[k] - bh)
            out += al @ bh
            out += ah @ bl
        out += ah @ bh
    return out


def stage3_case(seed=0, n=2000, c=128, absent=0.55):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, c)).astype(np.float32)
    table = rng.integers(0, n, (27, n))
    table[rng.random((27, n)) < absent] = n
    w = (rng.normal(size=(27, c, c)) / np.sqrt(27 * c)).astype(np.float32)
    plain = gather_conv_plain(torch.from_numpy(x),
                              torch.from_numpy(table.astype(np.int32)),
                              torch.from_numpy(w)).numpy()
    tol = K2_RTOL * max(1.0, float(np.abs(plain).max()))
    return x, table, w, plain, tol


def test_3xtf32_stays_within_k2_tolerance_at_stage3_width():
    x, table, w, plain, tol = stage3_case()
    err = float(np.abs(emulate_wide(x, table, w, split=True) - plain).max())
    assert err <= tol, (err, tol)


def test_1xtf32_does_not_stay_within_k2_tolerance():
    """The reason for the split: one TF32 product per pair misses the 1e-5
    tolerance by more than an order of magnitude."""
    x, table, w, plain, tol = stage3_case()
    err = float(np.abs(emulate_wide(x, table, w, split=False) - plain).max())
    assert err > 10 * tol, (err, tol)


def test_tf32_rounding_keeps_ten_mantissa_bits():
    a = np.array([1.0, 1.0 + 2.0 ** -11, 1.0 + 2.0 ** -10 + 2.0 ** -12,
                  -(1.0 + 2.0 ** -11), 3.0 + 2.0 ** -20], np.float32)
    np.testing.assert_array_equal(
        tf32_rna(a), np.array([1.0, 1.0 + 2.0 ** -10, 1.0 + 2.0 ** -10,
                               -(1.0 + 2.0 ** -10), 3.0], np.float32))
