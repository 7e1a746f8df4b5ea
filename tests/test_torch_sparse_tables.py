"""The sparse middle's table builders as operators
(`torch.ops.futuredet.make_grid`, `neighbor_table`, `downsample_coords`,
`strided_gather_table`, `strided_inverse_table`; `ops/sparse_conv.py`).

On the CPU: the operators run the plain builders (which
`tests/test_torch_sparse_conv.py` and `tests/test_torch_train_sparse.py`
hold to the JAX tables) and never the card's; the site map ranks every
site at its sorted position; a numpy copy of the card's algorithm
(`csrc/sparse_tables.cu`: bits, scan, rank lookups, the downsample's
compaction in bit order) gives the plain tables bit for bit; the
operators pass `opcheck` and trace under `torch.export`, a downsample's
site count an unbacked size; a grid refuses a site outside itself or its
batch, and two sites in one cell.

On the card (`-m cuda`; imports nothing of JAX):

    python -m pytest --noconftest -m cuda tests/test_torch_sparse_tables.py

the kernels give the plain builders' outputs (run on the card) bit for
bit at the published stage grids, B = 1 and 2, stage 3's pads, N = 0 and
1 and sites on every face; a full-width VoxelNet scene detects the same
boxes through either; and the table builds of a full-width scene and the
middle of a train step sync once a downsample, 3 times, and a scene's
builds launch at most 40 kernels and copies; the sites a CPU grid
refuses fail a device-side assert.
"""
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from futuredet_torch.ops import sparse_conv as sc  # noqa: E402

# the stage grids of the published VoxelNet (41 x 1440 x 1440, then three
# stride-2 convs, stage 3 with z padding 0) and each stage's pads
STAGES = [((41, 1440, 1440), (1, 1, 1)), ((21, 720, 720), (1, 1, 1)),
          ((11, 360, 360), (1, 1, 1)), ((5, 180, 180), (0, 1, 1))]
# a site count of each stage as a 130k-voxel scene leaves it
STAGE_SITES = [130_000, 60_000, 20_000, 5_000]
OPS = ("make_grid", "neighbor_table", "downsample_coords",
       "strided_gather_table", "strided_inverse_table")


def rand_sites(rng, dims, n, batch_size=1):
    """n distinct sites of each sample, shuffled across the batch:
    (coords (N, 3), batch (N,)) int64 numpy."""
    cells = int(np.prod(dims))
    lin = np.concatenate([rng.choice(cells, n, replace=False)
                          for _ in range(batch_size)])
    batch = np.repeat(np.arange(batch_size), n)
    perm = rng.permutation(len(lin))
    lin, batch = lin[perm], batch[perm]
    coords = np.stack([lin // (dims[1] * dims[2]), (lin // dims[2]) % dims[1],
                       lin % dims[2]], -1)
    return coords, batch


def face_sites(dims):
    """The 8 corners and the centre of each of the 6 faces of `dims`."""
    Z, Y, X = dims
    pts = {(z, y, x) for z in (0, Z - 1) for y in (0, Y - 1)
           for x in (0, X - 1)}
    mid = (Z // 2, Y // 2, X // 2)
    for axis, end in ((0, Z - 1), (1, Y - 1), (2, X - 1)):
        for v in (0, end):
            p = list(mid)
            p[axis] = v
            pts.add(tuple(p))
    return np.array(sorted(pts))


def build_all(coords, batch, dims, pads, batch_size, builders):
    """Every table of one stage boundary through `builders` (a namespace
    with the five builders): the grid and its permutation, its neighbour
    table, the downsampled grid and its neighbour table, the strided
    gather and inverse tables."""
    grid, order = builders.make_grid(coords, dims, batch, batch_size)
    out_dims = sc.out_dims_of(dims, pads)
    out = builders.downsample_coords(grid, out_dims, pads)
    return {"grid": grid, "order": order,
            "table": builders.neighbor_table(grid, dims),
            "out": out, "out_table": builders.neighbor_table(out, out_dims),
            "strided": builders.strided_gather_table(grid, out, dims,
                                                     pads=pads),
            "inverse": builders.strided_inverse_table(grid, out, out_dims,
                                                      pads=pads)}


class Plain:
    """The plain builders called directly, on any device."""

    @staticmethod
    def make_grid(coords, dims, batch=None, batch_size=1):
        c, b, ids, order, m = sc._make_grid_cpu(coords, batch, list(dims),
                                                batch_size)
        return sc.SparseGrid(c, b, ids, m), order

    @staticmethod
    def neighbor_table(grid, dims):
        return sc._neighbor_table_cpu(*grid, list(dims))

    @staticmethod
    def downsample_coords(grid, out_dims, pads):
        return sc.SparseGrid(*sc._downsample_coords_cpu(
            grid.coords, grid.batch, list(out_dims), list(pads),
            grid.sitemap.shape[0]))

    @staticmethod
    def strided_gather_table(in_grid, out_grid, dims, pads):
        return sc._strided_gather_table_cpu(
            out_grid.coords, out_grid.batch, in_grid.ids, in_grid.sitemap,
            list(dims), list(pads))

    @staticmethod
    def strided_inverse_table(in_grid, out_grid, out_dims, pads):
        return sc._strided_inverse_table_cpu(
            in_grid.coords, in_grid.batch, out_grid.ids, out_grid.sitemap,
            list(out_dims), list(pads))


def assert_same(got, want):
    """Every tensor of two `build_all` results equal, dtype and shape
    included."""
    for key in want:
        g, w = got[key], want[key]
        pairs = zip(g, w) if isinstance(w, tuple) else [(g, w)]
        for a, b in pairs:
            assert a.dtype == b.dtype and a.shape == b.shape, key
            assert torch.equal(a.cpu(), b.cpu()), key


def launches():
    return {fn.__name__: fn.launches for fn in sc.TABLE_BUILDERS}


# ---- the CPU ---------------------------------------------------------------

# (dims, sites a sample, batch size, pads): random sites at small grids,
# stage 3's z padding 0, an odd x extent (the last word part empty), one
# site, none
CPU_CASES = [((21, 12, 12), 500, 1, (1, 1, 1)),
             ((11, 20, 20), 400, 2, (1, 1, 1)),
             ((5, 18, 18), 300, 1, (0, 1, 1)),
             ((9, 7, 13), 200, 2, (1, 1, 1)),
             ((5, 6, 6), 1, 1, (1, 1, 1)),
             ((5, 6, 6), 0, 2, (0, 1, 1))]


@pytest.mark.parametrize("dims,n,B,pads", CPU_CASES)
def test_cpu_operators_run_the_plain_builders(dims, n, B, pads):
    coords, batch = rand_sites(np.random.default_rng(n + B), dims, n, B)
    c, b = torch.from_numpy(coords), torch.from_numpy(batch)
    before = launches()
    got = build_all(c, b, dims, pads, B, sc)
    assert launches() == before           # nothing ran on a card
    assert_same(got, build_all(c, b, dims, pads, B, Plain))
    assert got["grid"].sitemap.shape == (B, sc.sitemap_words(dims), 2)
    assert got["table"].shape == (27, B * n)


@pytest.mark.parametrize("dims,n,B,pads", CPU_CASES)
def test_sitemap_ranks_every_site_at_its_sorted_position(dims, n, B, pads):
    coords, batch = rand_sites(np.random.default_rng(7 * n + B), dims, n, B)
    grid, _ = sc.make_grid(torch.from_numpy(coords), dims,
                           torch.from_numpy(batch), B)
    m = grid.sitemap.numpy().reshape(-1, 2)
    words = sc.sitemap_words(dims)
    bit = (grid.batch.numpy() * words * 32
           + sc.linear_ids(grid.coords, dims).numpy())
    w, j = bit >> 5, bit & 31
    bits = m[:, 0].view(np.uint32)
    assert ((bits[w] >> j) & 1).all()
    below = bits[w] & ((np.uint32(1) << j.astype(np.uint32)) - np.uint32(1))
    np.testing.assert_array_equal(m[w, 1] + np.bitwise_count(below),
                                  np.arange(len(bit)))
    assert int(np.bitwise_count(bits).sum()) == len(bit)
    np.testing.assert_array_equal(
        m[:, 1], np.cumsum(np.bitwise_count(bits)) - np.bitwise_count(bits))


class CardAlgorithm:
    """A numpy copy of csrc/sparse_tables.cu's algorithm (not its code):
    the site map from the sites' bits (OR) and the scan of their counts,
    ranks by `prefix + popcount`, the downsample's candidates ORed into
    the output map and read back in bit order, and one lookup for the
    three tables, query cell (scale * c + sign * offset + shift) / div."""

    @staticmethod
    def _map(bit, total_bits):
        bits = np.zeros(total_bits // 32, np.uint32)
        np.bitwise_or.at(bits, bit >> 5, np.uint32(1) << (bit & 31).astype(
            np.uint32))
        count = np.bitwise_count(bits).astype(np.int64)
        return np.stack([bits.view(np.int32),
                         (np.cumsum(count) - count).astype(np.int32)], -1)

    @staticmethod
    def _rank(m, bit, absent):
        bits = m[:, 0].view(np.uint32)[bit >> 5]
        j = (bit & 31).astype(np.uint32)
        below = bits & ((np.uint32(1) << j) - np.uint32(1))
        hit = ((bits >> j) & 1).astype(bool)
        return np.where(hit, m[bit >> 5, 1] + np.bitwise_count(below),
                        absent)

    @classmethod
    def _grid(cls, m, dims, batch_size):
        words = sc.sitemap_words(dims)
        bits = np.ascontiguousarray(m.reshape(-1, 2)[:, 0]).view(np.uint32)
        bit = np.flatnonzero(np.unpackbits(
            bits.view(np.uint8), bitorder="little"))     # ascending
        b, cell = bit // (32 * words), bit % (32 * words)
        Y, X = dims[1], dims[2]
        coords = np.stack([cell // (Y * X), (cell // X) % Y, cell % X], -1)
        return sc.SparseGrid(torch.from_numpy(coords), torch.from_numpy(b),
                             torch.from_numpy(b * int(np.prod(dims)) + cell),
                             torch.from_numpy(m.reshape(batch_size, words,
                                                        2)))

    @classmethod
    def make_grid(cls, coords, dims, batch=None, batch_size=1):
        c, b = coords.numpy(), batch.numpy()
        words = sc.sitemap_words(dims)
        bit = b * words * 32 + sc.linear_ids(c, dims)
        m = cls._map(bit, batch_size * words * 32)
        rank = cls._rank(m, bit, -1)
        order = np.empty(len(bit), np.int64)
        order[rank] = np.arange(len(bit))
        return cls._grid(m, dims, batch_size), torch.from_numpy(order)

    @classmethod
    def downsample_coords(cls, grid, out_dims, pads):
        B = grid.sitemap.shape[0]
        words = sc.sitemap_words(out_dims)
        p = grid.coords.numpy() + np.array(pads)
        bits = []
        for sel in np.ndindex(2, 2, 2):
            q = (p >> 1) - np.array(sel)
            ok = ((q >= 0) & (q < np.array(out_dims))
                  & ((np.array(sel) == 0) | (p % 2 == 0))).all(-1)
            bits.append((grid.batch.numpy() * words * 32
                         + sc.linear_ids(q, out_dims))[ok])
        m = cls._map(np.concatenate(bits), B * words * 32)
        return cls._grid(m, out_dims, B)

    @classmethod
    def _table(cls, coords, batch, target, dims, scale, sign, shift, div):
        c, b = coords.numpy(), batch.numpy()
        words = sc.sitemap_words(dims)
        offs = np.array(sc._offsets())
        q = scale * c[None] + sign * offs[:, None] + np.array(shift)
        whole = ((q % div) == 0).all(-1)
        q = q // div
        inside = ((q >= 0) & (q < np.array(dims))).all(-1) & whole
        bit = b[None] * words * 32 + sc.linear_ids(np.where(
            inside[..., None], q, 0), dims)
        n = len(target.ids)
        rank = cls._rank(target.sitemap.numpy().reshape(-1, 2), bit, n)
        return torch.from_numpy(np.where(inside, rank, n).astype(np.int32))

    @classmethod
    def neighbor_table(cls, grid, dims):
        return cls._table(grid.coords, grid.batch, grid, dims, 1, 1,
                          (0, 0, 0), 1)

    @classmethod
    def strided_gather_table(cls, in_grid, out_grid, dims, pads):
        return cls._table(out_grid.coords, out_grid.batch, in_grid, dims, 2,
                          1, [1 - p for p in pads], 1)

    @classmethod
    def strided_inverse_table(cls, in_grid, out_grid, out_dims, pads):
        return cls._table(in_grid.coords, in_grid.batch, out_grid, out_dims,
                          1, -1, [p - 1 for p in pads], 2)


@pytest.mark.parametrize("dims,n,B,pads", CPU_CASES)
def test_the_card_algorithm_gives_the_plain_tables(dims, n, B, pads):
    coords, batch = rand_sites(np.random.default_rng(3 * n + B), dims, n, B)
    faces = face_sites(dims)
    coords = np.concatenate([coords, faces]) if n else coords
    batch = np.concatenate([batch, np.full(len(faces), B - 1)]) if n \
        else batch
    keep = np.unique(batch * 10**9 + sc.linear_ids(coords, dims),
                     return_index=True)[1]          # distinct sites
    c, b = torch.from_numpy(coords[keep]), torch.from_numpy(batch[keep])
    assert_same(build_all(c, b, dims, pads, B, CardAlgorithm),
                build_all(c, b, dims, pads, B, Plain))


# (name, coords, batch) of sites a grid must not take, over dims (5, 6, 6)
# and a batch of 2
BAD_SITES = {"outside the grid": ([[0, 0, 0], [4, 6, 5]], [0, 0]),
             "below the grid": ([[0, 0, 0], [0, -1, 0]], [0, 1]),
             "outside the batch": ([[0, 0, 0], [1, 1, 1]], [0, 2]),
             "two in one cell": ([[1, 2, 3], [0, 0, 0], [1, 2, 3]],
                                 [1, 0, 1])}


@pytest.mark.parametrize("name", BAD_SITES)
def test_the_cpu_grid_refuses_sites_the_card_would_assert_on(name):
    coords, batch = BAD_SITES[name]
    with pytest.raises(ValueError, match="make_grid"):
        sc.make_grid(torch.tensor(coords), (5, 6, 6), torch.tensor(batch), 2)


def op_args(seed=0, dims=(7, 10, 12), n=150, B=2, pads=(0, 1, 1)):
    coords, batch = rand_sites(np.random.default_rng(seed), dims, n, B)
    c, b = torch.from_numpy(coords), torch.from_numpy(batch)
    grid, _ = sc.make_grid(c, dims, b, B)
    out_dims = sc.out_dims_of(dims, pads)
    out = sc.downsample_coords(grid, out_dims, pads)
    return {
        "make_grid": (c.int(), b, list(dims), B),
        "neighbor_table": (*grid, list(dims)),
        "downsample_coords": (grid.coords, grid.batch, list(out_dims),
                              list(pads), B),
        "strided_gather_table": (out.coords, out.batch, grid.ids,
                                 grid.sitemap, list(dims), list(pads)),
        "strided_inverse_table": (grid.coords, grid.batch, out.ids,
                                  out.sitemap, list(out_dims), list(pads))}


@pytest.mark.parametrize("op", OPS)
def test_opcheck_of_the_builders_on_the_cpu(op):
    # a downsample's site count is data-dependent: its fake gives an
    # unbacked size, which only the tracing tests take
    tests = (("test_schema", "test_autograd_registration")
             if op == "downsample_coords" else None)
    kw = {} if tests is None else {"test_utils": tests}
    torch.library.opcheck(getattr(torch.ops.futuredet, op).default,
                          op_args()[op], **kw)


class Tables(torch.nn.Module):
    """Every builder, as the middle chains them over one stage boundary."""

    def forward(self, coords, batch):
        dims, pads = (7, 10, 12), (0, 1, 1)
        got = build_all(coords, batch, dims, pads, 2, sc)
        return (got["table"], got["out"].ids, got["out_table"],
                got["strided"], got["inverse"], got["grid"].sitemap,
                got["out"].sitemap)


def test_export_keeps_each_builder_with_an_unbacked_site_count():
    args = op_args(seed=1)["make_grid"][:2]
    ep = torch.export.export(Tables(), args, strict=False)
    targets = [str(n.target) for n in ep.graph.nodes
               if n.op == "call_function"]
    assert [targets.count(f"futuredet.{op}.default") for op in OPS] == [
        1, 2, 1, 1, 1]
    out_ids = [n for n in ep.graph.nodes if n.op == "output"][0].args[0][1]
    n_out = out_ids.meta["val"].shape[0]
    assert isinstance(n_out, torch.SymInt)         # unbacked, not traced
    for seed in (1, 2):                            # a new set of sites too
        c, b = op_args(seed=seed)["make_grid"][:2]
        for g, w in zip(ep.module()(c, b), Tables()(c, b)):
            assert torch.equal(g, w)


# ---- the card --------------------------------------------------------------

def needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")


def on_card(*arrays):
    return [torch.from_numpy(a).cuda() for a in arrays]


# (stage, batch size): every published stage grid at B = 1 and 2
CARD_STAGES = [(s, B) for s in range(4) for B in (1, 2)]


@pytest.mark.cuda
@pytest.mark.parametrize("stage,B", CARD_STAGES)
def test_kernels_equal_the_plain_builders_at_the_stage_grids(stage, B):
    needs_card()
    dims, pads = STAGES[stage]
    coords, batch = rand_sites(np.random.default_rng(stage * 10 + B), dims,
                               STAGE_SITES[stage] // B, B)
    c, b = on_card(coords, batch)
    before = launches()
    got = build_all(c.int(), b, dims, pads, B, sc)
    torch.cuda.synchronize()
    after = launches()
    assert {k: after[k] - before[k] for k in after} == {
        "make_grid": 1, "neighbor_table": 2, "downsample_coords": 1,
        "strided_gather_table": 1, "strided_inverse_table": 1}
    assert_same(got, build_all(c, b, dims, pads, B, Plain))


# (name, dims, pads): edge cases at the published stage-3 and stage-0 grids
EDGE_CASES = [("none", STAGES[0][0], (1, 1, 1)),
              ("one", STAGES[3][0], (0, 1, 1)),
              ("faces", STAGES[0][0], (1, 1, 1)),
              ("faces", STAGES[3][0], (0, 1, 1)),
              ("faces of both samples", STAGES[1][0], (1, 1, 1))]


@pytest.mark.cuda
@pytest.mark.parametrize("name,dims,pads", EDGE_CASES)
def test_kernels_equal_the_plain_builders_at_the_edges(name, dims, pads):
    needs_card()
    B = 2 if "both" in name else 1
    if name == "none":
        coords = np.zeros((0, 3), np.int64)
    elif name == "one":
        coords = np.array([[dims[0] - 1, 0, dims[2] - 1]])
    else:
        coords = face_sites(dims)
    batch = np.repeat(np.arange(B), len(coords))
    coords = np.tile(coords, (B, 1))
    c, b = on_card(coords, batch)
    got = build_all(c, b, dims, pads, B, sc)
    assert_same(got, build_all(c, b, dims, pads, B, Plain))
    if name == "none":
        assert got["table"].shape == (27, 0) and len(got["out"].ids) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("name", BAD_SITES)
def test_the_card_grid_asserts_on_sites_the_cpu_refuses(name):
    """A device-side assert ends the CUDA context, so each case runs in a
    process of its own."""
    needs_card()
    import subprocess
    coords, batch = BAD_SITES[name]
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = ("import sys, torch; sys.path.insert(0, sys.argv[1]); "
            "from futuredet_torch.ops import sparse_conv as sc; "
            f"g, o = sc.make_grid(torch.tensor({coords}).cuda(), (5, 6, 6), "
            f"torch.tensor({batch}).cuda(), 2); torch.cuda.synchronize()")
    run = subprocess.run([sys.executable, "-c", code, root],
                         capture_output=True, text=True, timeout=300)
    assert run.returncode != 0
    assert "device-side assert" in run.stderr, run.stderr[-2000:]


def voxelnet_scene():
    import chip_smoke
    from futuredet_torch.config import get_config
    from futuredet_torch.models.detector import build_detector
    cfg = get_config("forecast_n3dtf")
    pts, valid = chip_smoke.scene_lidar(cfg, np.random.default_rng(5))
    model = build_detector(cfg, device="cuda", seed=0).eval()
    return cfg, model, *on_card(pts, valid)


def plain_middle(monkeypatch):
    """Route the middle to the plain builders, on the card."""
    from futuredet_torch.models import middle
    for name in OPS:
        monkeypatch.setattr(middle, name, getattr(Plain, name))


@pytest.mark.cuda
def test_voxelnet_scene_detects_the_same_boxes_through_either_builder(
        monkeypatch):
    needs_card()
    from futuredet_torch.eval.decode import decode_and_nms
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, model, pts, valid = voxelnet_scene()

    def detect():
        before = launches()
        with torch.no_grad():
            det = decode_and_nms(cfg, model(pts, valid))
        torch.cuda.synchronize()
        ran = sum(launches().values()) - sum(before.values())
        return det, list(model.backbone.site_counts), ran

    got, sites, ran = detect()
    assert ran == 11                    # 1 grid, 4 + 3 tables, 3 downsamples
    plain_middle(monkeypatch)
    want, want_sites, plain_ran = detect()
    assert plain_ran == 0 and sites == want_sites
    assert sites[0] > 100_000           # a full scene
    assert int(got.valid.sum()) > 0
    for f in ("boxes", "scores", "labels", "valid"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f


def span_counts(fn):
    """Launches and syncs a unit by span, from benchmark/spans.py's join of
    the program's spans with the profiler's CUDA calls."""
    from benchmark import spans
    rec = spans.measure(lambda i: fn(), units_a=1, units_b=2)
    assert rec is not None
    return rec["by_span"]


@pytest.mark.cuda
def test_table_builds_sync_once_a_downsample():
    needs_card()
    cfg, model, pts, valid = voxelnet_scene()

    def scene():
        with torch.no_grad():
            model(pts, valid)

    # the three downsamples' site counts, and no other
    tables = span_counts(scene)["middle.tables"]
    assert tables["syncs"] == 3 and tables["launches"] <= 40, tables

    from futuredet_torch.train.step import make_optimizer, train_step
    import chip_smoke
    batch = chip_smoke.train_batch(cfg, 0, "cuda", 0)
    model.train()
    opt = make_optimizer(cfg, model, 100)
    step = [0]

    def one_step():
        train_step(model, opt, batch, step[0])
        step[0] += 1

    middle = span_counts(one_step)["middle"]
    assert middle["syncs"] == 3, middle
