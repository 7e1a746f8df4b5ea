"""K2's families, on the CPU: which family takes each conv, why the wide
family's tensor-core arithmetic is 3xTF32 and not plain TF32, and the bf16
family's packed reduction and sub-paths.

The wide family (csrc/gather_conv_kernel.cu) multiplies on the tensor cores
in TF32, which keeps 10 of fp32's 23 mantissa bits. It splits each operand
into hi = rna(x) and lo = rna(x - hi) and sums lo*hi + hi*lo + hi*hi in
fp32. The emulation below repeats that arithmetic in numpy at the stage-3
width (27 taps x 128 channels deep, 55% of the rows absent, 128 outputs)
and holds it to K2's tolerance against its plain fp32 version: 1e-5 of
max(1, max|plain|). 3xTF32 stays inside it (~4e-7); one TF32 product per
pair does not (~3e-4), which is why the kernel pays three MMAs per
fragment instead of one.

The bf16 family (csrc/gather_conv_bf16_kernel.cu) cuts its reduction into
64-slot chunks of (tap, channel) K-slots, each tap rounded up to 8 slots.
A numpy model of its producer (granules of 8 slots, zeros past Cin and past
the 27th tap) is held against the wrapper's mirror `bf16_k_slots`, checked
to cover every (tap, channel) once, and the packed product A @ W against
`gather_conv_plain`; `k2_bf16_plan` is checked against the constants of
the source and the 227 KB of shared memory a block may have.
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from futuredet_torch.ops import pallas_gather
from futuredet_torch.ops.pallas_gather import (COUTS, bf16_k_slots,
                                               gather_conv, gather_conv_plain,
                                               k2_bf16_plan, k2_route)

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


BF16_CU = (Path(pallas_gather.__file__).resolve().parent.parent / "csrc"
           / "gather_conv_bf16_kernel.cu")
BF16_CINS = (1, 3, 5, 8, 16, 24, 32, 40, 64, 128)


def test_bf16_constants_match_the_source():
    src = BF16_CU.read_text()

    def const(name):
        m = re.search(rf"constexpr int {name} = (\d+);", src)
        assert m, name
        return int(m.group(1))

    assert const("kChunk") == pallas_gather.BF16_CHUNK
    assert const("kStages") == pallas_gather.BF16_STAGES
    assert const("kProducers") == pallas_gather.BF16_PRODUCERS
    assert const("kResidentBytes") == pallas_gather.BF16_RESIDENT_BYTES
    assert const("kSmemMax") == pallas_gather.BF16_SMEM_MAX == 227 * 1024
    assert const("kTaps") == pallas_gather.K_TAPS


def producer_model(cin):
    """The kernel's producer, granule by granule: chunk c's granule j holds
    K-slots 64c + 8j .. + 7 of one tap (CP = Cin rounded up to 8, so a
    granule never straddles two taps), channels ch0 .. ch0 + 7 of it, the
    ones at or past Cin and every slot past the 27th tap zero. Returns
    (tap, channel) per slot, -1 for a zero."""
    cp = -(-cin // 8) * 8
    chunks = -(-27 * cp // 64)
    tap = np.full(chunks * 64, -1)
    ch = np.full(chunks * 64, -1)
    for c in range(chunks):
        for j in range(8):
            s = 64 * c + 8 * j
            t, ch0 = divmod(s, cp)
            for i in range(8):
                if t < 27 and ch0 + i < cin:
                    tap[s + i], ch[s + i] = t, ch0 + i
    return tap, ch


@pytest.mark.parametrize("cin", BF16_CINS)
def test_bf16_k_slots_cover_every_tap_channel_once(cin):
    tap, ch = (t.numpy() for t in bf16_k_slots(cin))
    mtap, mch = producer_model(cin)
    np.testing.assert_array_equal(tap, mtap)
    np.testing.assert_array_equal(ch, mch)
    assert len(tap) % 64 == 0
    live = tap >= 0
    pairs = tap[live] * cin + ch[live]
    assert np.array_equal(np.sort(pairs), np.arange(27 * cin))
    assert (ch[~live] == -1).all()
    # the chunks: 4 at Cin = 5 (where the mma.sync kernel took 27 steps),
    # 7 at 16, 14 at 32, 27 at 64
    assert len(tap) // 64 == {1: 4, 3: 4, 5: 4, 8: 4, 16: 7, 24: 11,
                              32: 14, 40: 17, 64: 27, 128: 54}[cin]


@pytest.mark.parametrize("cin", BF16_CINS)
def test_bf16_packed_product_equals_the_plain_version(cin):
    """The packed A (N rows of chunks x 64 K-slots, gathered rows where the
    neighbour is present, zeros elsewhere) times the packed W (the same
    slots' rows of W, zeros on padding) is the conv, on seeded bf16
    inputs: every product is exact in fp32, only the order of the sums
    differs."""
    rng = np.random.default_rng(cin)
    V, N, cout = 300, 200, 16
    x = torch.from_numpy(rng.normal(size=(V, cin)).astype(np.float32)
                         ).bfloat16()
    table = rng.integers(0, V, (27, N))
    table[rng.random((27, N)) < 0.5] = V
    table[3] = V                       # a tap that no site has
    w = torch.from_numpy((rng.normal(size=(27, cin, cout))
                          / np.sqrt(27 * cin)).astype(np.float32)).bfloat16()
    b = torch.from_numpy(rng.normal(size=cout).astype(np.float32))
    tap, ch = (t.numpy() for t in bf16_k_slots(cin))
    xf, wf = x.float().numpy(), w.float().numpy()
    live = tap >= 0
    a = np.zeros((N, len(tap)), np.float32)
    idx = table[tap[live]]             # (live slots, N)
    ok = idx < V
    vals = np.where(ok, xf[np.minimum(idx, V - 1), ch[live][:, None]], 0.0)
    a[:, live] = vals.T
    wp = np.zeros((len(tap), cout), np.float32)
    wp[live] = wf[tap[live], ch[live]]
    got = a @ wp + b.numpy()
    want = gather_conv_plain(x, torch.from_numpy(table.astype(np.int32)),
                             w, b).numpy()
    tol = K2_RTOL * max(1.0, float(np.abs(want).max()))
    assert float(np.abs(got - want).max()) <= tol


@pytest.mark.parametrize("cout", COUTS)
def test_bf16_plan_fits_shared_memory_on_every_sub_path(cout):
    """Every (W resident or streamed, 64- or 128-site tile) the kernel
    instantiates for this Cout asks for at most 227 KB of shared memory
    for any Cin; resident W exactly where its packed chunks take at most
    128 KB."""
    seen = set()
    for cin in range(1, 1100):
        for n in (1, 128 * pallas_gather.H100_SMS):
            plan = k2_bf16_plan(cin, cout, n)
            seen.add((plan["w"], plan["tile"]))
            assert plan["smem"] <= pallas_gather.BF16_SMEM_MAX, (cin, plan)
            assert (plan["w"] == "resident") == (
                plan["w_bytes"] <= pallas_gather.BF16_RESIDENT_BYTES)
            assert plan["threads"] == 2 * plan["tile"] + 160
    assert seen == {(w, t) for w in ("resident", "streamed")
                    for t in (64, 128)}


@pytest.mark.parametrize("cin,cout,n,w,tile", [
    # the 20 bf16 convs of forecast_n3dtf's middle (chip_smoke.py phase
    # 29's N)
    (5, 16, 159852, "resident", 128), (16, 16, 159852, "resident", 128),
    (16, 32, 75608, "resident", 128), (32, 32, 75608, "resident", 128),
    (32, 64, 46375, "resident", 128), (64, 64, 46375, "streamed", 128),
    (64, 128, 31651, "streamed", 128), (128, 128, 31651, "streamed", 128),
    # small N: 64-site tiles
    (128, 128, 1000, "streamed", 64), (16, 8, 16768, "resident", 64),
    (16, 8, 16769, "resident", 128),
])
def test_bf16_plan_of_the_main_path(cin, cout, n, w, tile):
    plan = k2_bf16_plan(cin, cout, n)
    assert (plan["w"], plan["tile"]) == (w, tile)
    assert plan["rows"] == ("16B" if cin % 8 == 0 else "2B")


def test_bf16_plan_refuses_what_the_family_does_not_take():
    with pytest.raises(ValueError):
        k2_bf16_plan(16, 24, 100)
    with pytest.raises(ValueError):
        k2_bf16_plan(0, 16, 100)
