"""The two detectors in plain PyTorch, fp32, one sample at a time.

Frozen copy of `futuredet_torch/models/{detector,middle,readers,layers,
backbone2d,center_head}.py` and `futuredet_torch/ops/{voxelize,
sparse_conv}.py` at the modes that the benchmark's configurations run:
the sparse VoxelNet (mean VFE, the 4-stage submanifold middle, z_crush,
the RPN) and PointPillars (the direct pillar reader with the reference's
phantom-row floor, the RPN), each under the dense CenterHead with chained
forecast features. What changed from the port:

  * every sparse conv is one row gather over the reference's own
    neighbour table and one matmul (the stacked form of K2's plain
    version), differentiated by autograd;
  * no bf16 knob, dense middle, space layout, data parallelism, export
    path or head mode other than the dense forecast head;
  * BatchNorm statistics over one sample (B = 1 a card).

Module and parameter names are the port's, so one state dict loads into
both.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F
from torch import nn

BN_EPS, BN_MOMENTUM = 1e-3, 0.01
K_TAPS = 27


# --------------------------------------------------------------------------
# normalisation and dense layers
# --------------------------------------------------------------------------

class MaskedBatchNorm(nn.Module):
    """BatchNorm over (N, C) rows (sites or points): in training the mean
    and biased variance of the valid rows, the running statistics moved by
    `momentum`; in eval the running statistics."""

    def __init__(self, c: int, eps: float = BN_EPS,
                 momentum: float = BN_MOMENTUM):
        super().__init__()
        self.eps, self.momentum = eps, momentum
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))
        self.register_buffer("num_batches_tracked", torch.tensor(0))

    def forward(self, x: torch.Tensor, valid: torch.Tensor = None):
        if not self.training:
            return self.normalize(x, self.running_mean, self.running_var)
        w = x.new_ones(x.shape[0]) if valid is None else valid.to(x.dtype)
        cnt = torch.clamp_min(w.sum(), 1.0)
        mean = (x * w[:, None]).sum(0) / cnt
        var = (torch.square(x - mean) * w[:, None]).sum(0) / cnt
        with torch.no_grad():
            m = self.momentum
            self.running_mean.mul_(1 - m).add_(m * mean)
            self.running_var.mul_(1 - m).add_(m * var)
            self.num_batches_tracked.add_(1)
        return self.normalize(x, mean, var)

    def normalize(self, x, mean, var):
        return (x - mean) * torch.rsqrt(var + self.eps) * self.weight \
            + self.bias


class BatchNorm2d(nn.BatchNorm2d):
    """nn.BatchNorm2d whose training step moves the running variance by
    the biased batch variance (flax's rule, the port's)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0, self.eps)
        y = F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0,
                         self.eps)
        with torch.no_grad():
            var, mean = torch.var_mean(x, dim=(0, 2, 3), correction=0)
            m = self.momentum
            self.running_mean.mul_(1 - m).add_(m * mean)
            self.running_var.mul_(1 - m).add_(m * var)
            self.num_batches_tracked.add_(1)
        return y


class SplitConv2d(nn.Conv2d):
    """A Conv2d summed over groups of at most 128 input channels, as the
    port computes its RPN stems (cuDNN otherwise picks an FFT algorithm
    there: slow, and another rounding)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.in_channels <= 128:
            return super().forward(x)
        out = None
        for c0 in range(0, self.in_channels, 128):
            y = F.conv2d(x[:, c0:c0 + 128], self.weight[:, c0:c0 + 128],
                         None, self.stride, self.padding)
            out = y if out is None else out + y
        return out if self.bias is None else out + self.bias[:, None, None]


def conv_bn_relu(cin, cout, k=3, stride=1, bias=True, padding=None,
                 conv=nn.Conv2d) -> List[nn.Module]:
    p = (k - 1) // 2 if padding is None else padding
    return [conv(cin, cout, k, stride=stride, padding=p, bias=bias),
            BatchNorm2d(cout, eps=BN_EPS, momentum=BN_MOMENTUM), nn.ReLU()]


class RPN(nn.Module):
    """The multi-scale BEV neck (port `models/backbone2d.py`)."""

    def __init__(self, cin: int, r: Dict):
        super().__init__()
        blocks, deblocks = [], []
        start = len(r["layer_nums"]) - len(r["us_strides"])
        self.start = start
        for i, n in enumerate(r["layer_nums"]):
            c, s = r["ds_filters"][i], r["ds_strides"][i]
            layers = [nn.ZeroPad2d(1), *conv_bn_relu(cin, c, 3, s, False, 0,
                                                     SplitConv2d)]
            for _ in range(n):
                layers += conv_bn_relu(c, c, 3, 1, False)
            blocks.append(nn.Sequential(*layers))
            k = i - start
            if k >= 0:
                us, uf = r["us_strides"][k], r["us_filters"][k]
                if us > 1:
                    deblocks.append(nn.Sequential(
                        nn.ConvTranspose2d(c, uf, int(us), stride=int(us),
                                           bias=False),
                        BatchNorm2d(uf, eps=BN_EPS, momentum=BN_MOMENTUM),
                        nn.ReLU()))
                else:
                    st = int(round(1 / us))
                    deblocks.append(nn.Sequential(*conv_bn_relu(
                        c, uf, st, st, False)))
            cin = c
        self.blocks = nn.ModuleList(blocks)
        self.deblocks = nn.ModuleList(deblocks)

    def forward(self, x):
        ups = []
        for i, block in enumerate(self.blocks):
            x = block(x)
            if i - self.start >= 0:
                ups.append(self.deblocks[i - self.start](x))
        return torch.cat(ups, 1)


class SepHead(nn.Module):
    """One task of the dense forecast head: forecast_conv, then one conv
    tower per branch (port `models/center_head.py::SepHead`)."""

    def __init__(self, cin: int, heads, head_conv: int):
        super().__init__()
        self.names = [n for n, _ in heads]
        self.forecast_conv = nn.Sequential(
            *conv_bn_relu(cin, head_conv, 3, 1, True),
            *conv_bn_relu(head_conv, head_conv, 3, 1, True))
        for name, (classes, num_conv) in heads:
            layers = []
            for _ in range(num_conv - 1):
                layers += conv_bn_relu(head_conv, head_conv, 3, 1, True)
            layers.append(nn.Conv2d(head_conv, classes, 3, padding=1))
            self.add_module(name, nn.Sequential(*layers))

    def forward(self, x):
        x = self.forecast_conv(x)
        out = {"feats": x}
        for name in self.names:
            out[name] = getattr(self, name)(x)
        return out


class CenterHead(nn.Module):
    def __init__(self, h: Dict):
        super().__init__()
        if not (h["dense"] and h["forecast_feature"]) or h["two_stage"] \
                or h["dcn_head"] or h["bev_map"]:
            raise ValueError("the reference runs the dense forecast head")
        share = h["share_conv_channel"]
        self.shared_conv = nn.Sequential(*conv_bn_relu(h["in_channels"],
                                                       share, 3, 1, True))
        heads = tuple((n, tuple(v)) for n, v in h["common_heads"]) \
            + (("hm", (1, h["num_hm_conv"])),)
        self.tasks = nn.ModuleList([
            SepHead(share if i == 0 else 2 * share, heads, share)
            for i in range(h["timesteps"])])

    def forward(self, x) -> List[Dict[str, torch.Tensor]]:
        x = self.shared_conv(x)
        rets = []
        for i, task in enumerate(self.tasks):
            rets.append(task(x if i == 0 else
                             torch.cat([x, rets[-1]["feats"]], 1)))
        return [{k: v.permute(0, 2, 3, 1) for k, v in r.items()
                 if k != "feats"} for r in rets]


# --------------------------------------------------------------------------
# voxelization and sparse convolution
# --------------------------------------------------------------------------

def voxel_means(points, valid, v: Dict):
    """One sample's points (P, F) -> (mean features (N, F), zyx coords
    (N, 3) int64) of its occupied voxels, at most `max_voxels` (the lowest
    linear ids), each the mean of its first `max_points_per_voxel` points
    in input order (port `ops/voxelize.py`)."""
    gx, gy, gz = grid_size(v)
    dev = points.device
    rmin = torch.tensor(v["pc_range"][:3], dtype=points.dtype, device=dev)
    vs = torch.tensor(v["voxel_size"], dtype=points.dtype, device=dev)
    c = torch.floor((points[:, :3] - rmin) / vs).to(torch.int64)
    gs = torch.tensor((gx, gy, gz), device=dev)
    ok = valid & ((c >= 0) & (c < gs)).all(-1)
    total = gx * gy * gz
    key = torch.where(ok, (c[:, 2] * gy + c[:, 1]) * gx + c[:, 0],
                      torch.full_like(c[:, 0], total))
    skey, order = torch.sort(key, stable=True)
    head = skey < total
    head[1:] &= skey[1:] != skey[:-1]
    first = torch.nonzero(head).squeeze(1)
    n_ok = (skey < total).sum().view(1)
    run = torch.diff(first, append=n_ok)
    first, run = first[:v["max_voxels"]], run[:v["max_voxels"]]
    lin = skey[first]
    num = torch.clamp_max(run, v["max_points_per_voxel"])
    pts = points[order]
    acc = pts.new_zeros((len(first), pts.shape[1]))
    for r in range(v["max_points_per_voxel"]):
        rows = pts.index_select(0, torch.clamp_max(first + r, len(pts) - 1))
        acc = acc + torch.where((num > r)[:, None], rows, 0.0)
    coords = torch.stack([lin // (gx * gy), (lin // gx) % gy, lin % gx], -1)
    return acc / num[:, None].to(acc.dtype), coords


def grid_size(v: Dict) -> Tuple[int, int, int]:
    pc, vs = v["pc_range"], v["voxel_size"]
    return tuple(round((pc[i + 3] - pc[i]) / vs[i]) for i in range(3))


def _offsets():
    return [(dz, dy, dx) for dz in (-1, 0, 1) for dy in (-1, 0, 1)
            for dx in (-1, 0, 1)]


def linear_ids(c, dims):
    return (c[..., 0] * dims[1] + c[..., 1]) * dims[2] + c[..., 2]


def lookup(ids, q, dims):
    """Index into the sorted site ids of the site at coords q (..., 3), N
    where q lies outside `dims` or holds no site."""
    inb = ((q >= 0) & (q < torch.tensor(dims, device=q.device))).all(-1)
    key = linear_ids(q, dims)
    pos = torch.searchsorted(ids, key)
    padded = torch.cat([ids, ids.new_full((1,), -1)])
    found = inb & (padded[pos.clamp_max(len(ids))] == key)
    return torch.where(found, pos, len(ids))


def subm_table(coords, ids, dims):
    """(27, N) submanifold gather table; N where a neighbour is absent."""
    offs = torch.tensor(_offsets(), device=coords.device)
    return lookup(ids, coords[None] + offs[:, None], dims)


def out_dims_of(dims, pads):
    return tuple((d + 2 * p - 3) // 2 + 1 for d, p in zip(dims, pads))


def downsample(coords, out_dims, pads):
    """The output sites of a kernel-3 stride-2 sparse conv (spconv's
    generative rule): (coords, ids), ascending."""
    dev = coords.device
    p = coords + torch.tensor(pads, device=dev)
    hi = torch.div(p, 2, rounding_mode="floor")
    has2 = (p % 2) == 0
    od = torch.tensor(out_dims, device=dev)
    keys = []
    for bz in (0, 1):
        for by in (0, 1):
            for bx in (0, 1):
                sel = torch.tensor([bz, by, bx], device=dev)
                q = hi - sel
                ok = ((q >= 0) & (q < od)).all(-1) & ((sel == 0)
                                                      | has2).all(-1)
                keys.append(linear_ids(q, out_dims)[ok])
    ids = torch.unique(torch.cat(keys))
    Y, X = out_dims[1], out_dims[2]
    return torch.stack([ids // (Y * X), (ids // X) % Y, ids % X], -1), ids


def strided_table(in_ids, out_coords, dims, pads):
    """(27, N_out) indices into the input sites of a kernel-3 stride-2
    conv; `dims` is the input grid."""
    dev = out_coords.device
    offs = torch.tensor(_offsets(), device=dev)
    shift = 1 - torch.tensor(pads, device=dev)
    return lookup(in_ids, 2 * out_coords[None] + offs[:, None] + shift, dims)


class SparseConv(nn.Module):
    """A 3x3x3 sparse conv over a gather table: one row gather of every
    (site, tap) pair and one matmul. `weight` is spconv's (3, 3, 3, Cin,
    Cout), tap k = (dz+1)*9 + (dy+1)*3 + (dx+1)."""

    def __init__(self, cin: int, cout: int, bias: bool = True):
        super().__init__()
        self.cin, self.cout = cin, cout
        self.weight = nn.Parameter(torch.zeros(3, 3, 3, cin, cout))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None

    def forward(self, x, table):
        padded = torch.cat([x, x.new_zeros(1, self.cin)])
        g = padded.index_select(0, table.t().reshape(-1)).view(
            table.shape[1], K_TAPS * self.cin)
        out = g @ self.weight.reshape(K_TAPS * self.cin, self.cout)
        return out if self.bias is None else out + self.bias


class SparseBasicBlock(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.conv1, self.bn1 = SparseConv(c, c), MaskedBatchNorm(c)
        self.conv2, self.bn2 = SparseConv(c, c), MaskedBatchNorm(c)

    def forward(self, x, table):
        y = torch.relu(self.bn1(self.conv1(x, table)))
        return torch.relu(self.bn2(self.conv2(y, table)) + x)


def stage_pads(s, dims):
    pads = (0, 1, 1) if s == 3 else (1, 1, 1)
    return (1, 1, 1) if out_dims_of(dims, pads)[0] < 1 else pads


class SparseMiddle(nn.Module):
    """4 stages of {stride-2 sparse conv, 2 submanifold residual blocks},
    then the last stage on a dense (Y, X, Z*C) canvas and the z-mask of
    the reference's extra conv (port `models/middle.py`)."""

    def __init__(self, cin: int, channels, grid_zyx):
        super().__init__()
        self.grid_zyx = tuple(grid_zyx)
        c = channels
        self.conv_input = nn.ModuleList([SparseConv(cin, c[0], bias=False),
                                         MaskedBatchNorm(c[0])])
        self.conv1 = nn.ModuleList([SparseBasicBlock(c[0]) for _ in range(2)])
        for s in range(1, 4):
            self.add_module(f"conv{s + 1}", nn.ModuleList([
                SparseConv(c[s - 1], c[s], bias=False), MaskedBatchNorm(c[s]),
                nn.ReLU(), SparseBasicBlock(c[s]), SparseBasicBlock(c[s])]))

    def plan(self, coords):
        """The sites and tables of every stage for voxels at `coords`
        (N, 3) zyx: (the sorting order of the voxels, per stage (gather
        table of its first conv, N_in of that table, the stage's
        submanifold table), and the last stage's (ids, dims))."""
        dims = self.grid_zyx
        ids, order = torch.sort(linear_ids(coords, dims))
        coords = coords[order]
        table = subm_table(coords, ids, dims)
        stages = [(table, len(ids), table)]
        for s in range(1, 4):
            pads = stage_pads(s, dims)
            out_dims = out_dims_of(dims, pads)
            ncoords, nids = downsample(coords, out_dims, pads)
            dtable = strided_table(ids, ncoords, dims, pads)
            n_in = len(ids)
            coords, ids, dims = ncoords, nids, out_dims
            stages.append((dtable, n_in, subm_table(coords, ids, dims)))
        return order, stages, (ids, dims)

    def convs(self, coords) -> List[Tuple[torch.Tensor, int, int, int]]:
        """(gather table, N_in, Cin, Cout) of each of the 20 sparse convs,
        in the order the forward runs them."""
        _, stages, _ = self.plan(coords)
        out = []
        for s, (first, n_in, table) in enumerate(stages):
            mods = self.conv_input if s == 0 else getattr(self, f"conv{s + 1}")
            blocks = self.conv1 if s == 0 else mods[3:]
            out.append((first, n_in, mods[0].cin, mods[0].cout))
            for b in blocks:
                out += 2 * [(table, table.shape[1], b.conv1.cin,
                             b.conv1.cout)]
        return out

    def forward(self, feats, coords):
        order, stages, (ids, dims) = self.plan(coords)
        x = feats[order]
        for s, (first, _n_in, table) in enumerate(stages):
            if s == 0:
                conv, bn = self.conv_input
                x = torch.relu(bn(conv(x, first)))
                blocks = self.conv1
            else:
                down, bn, _relu, *blocks = getattr(self, f"conv{s + 1}")
                x = torch.relu(bn(down(x, first)))
            for block in blocks:
                x = block(x, table)
        Z, Y, X = dims
        C = x.shape[1]
        canvas = x.new_zeros((Z * Y * X, C)).index_copy_(0, ids, x)
        canvas = canvas.view(Z, Y, X, C)
        mask = torch.zeros(Z * Y * X, dtype=torch.bool, device=x.device)
        mask[ids] = True
        mask = mask.view(Z, Y, X)
        if Z >= 3:
            zmask = torch.stack([mask[2 * d:2 * d + 3].any(0)
                                 for d in range((Z - 3) // 2 + 1)], -1)
        else:
            zmask = mask.any(0)[..., None]
        bev = canvas.permute(1, 2, 0, 3).reshape(1, Y, X, Z * C)
        return bev, zmask[None]


class VoxelNet(nn.Module):
    def __init__(self, e: Dict):
        super().__init__()
        m = e["model"]
        self.voxel = dict(e["voxel"])
        gx, gy, gz = grid_size(self.voxel)
        self.backbone = SparseMiddle(m["num_input_features"],
                                     m["middle_channels"], (gz + 1, gy, gx))
        dims = self.backbone.grid_zyx
        for s in range(1, 4):
            dims = out_dims_of(dims, stage_pads(s, dims))
        self.z_crush = nn.Sequential(*conv_bn_relu(
            dims[0] * m["middle_channels"][-1], m["rpn"]["in_channels"], 1, 1,
            False))
        self.neck = RPN(m["rpn"]["in_channels"], m["rpn"])
        self.bbox_head = CenterHead(m["head"])

    def voxels(self, points, valid):
        """One sample's (mean features, zyx coords) under the voxel budget
        of the mode."""
        v = dict(self.voxel, max_voxels=self.voxel[
            "max_voxels_train" if self.training else "max_voxels_eval"])
        return voxel_means(points, valid, v)

    def forward(self, points, valid):
        """points (1, P, F), valid (1, P) -> per task a dict of NHWC maps."""
        feats, coords = self.voxels(points[0], valid[0])
        bev, zmask = self.backbone(feats, coords)
        x = self.z_crush(bev.permute(0, 3, 1, 2))
        Dz = zmask.shape[-1]
        zm = zmask.permute(0, 3, 1, 2).to(x.dtype)
        x = x * (zm.repeat(1, x.shape[1] // Dz, 1, 1)
                 if x.shape[1] % Dz == 0 else zm.amax(1, keepdim=True))
        return self.bbox_head(self.neck(x))


class PFNLayer(nn.Module):
    def __init__(self, cin, units):
        super().__init__()
        self.linear = nn.Linear(cin, units, bias=False)
        self.norm = MaskedBatchNorm(units)


class PillarReader(nn.Module):
    """The sortless pillar reader (port `models/readers.py::
    PillarFeatureNetDirect`): points decorated with their pillar's cluster
    and centre offsets, Linear + BN + ReLU, max-pooled into the canvas; a
    pillar of fewer than `pad_floor_cap` points also pools the reference's
    zero-padded phantom row."""

    def __init__(self, m: Dict, v: Dict):
        super().__init__()
        self.v = v
        self.cap = v["max_points_per_voxel"] if m["pfn_pad_floor"] else 0
        layers, cin = [], m["num_input_features"] + 5
        filters = m["pillar_filters"]
        for i, ch in enumerate(filters):
            units = ch if i == len(filters) - 1 else ch // 2
            layers.append(PFNLayer(cin, units))
            cin = 2 * units
        self.pfn_layers = nn.ModuleList(layers)

    def forward(self, pts, valid):
        v = self.v
        gx, gy, _ = grid_size(v)
        H, W = gy, gx
        (x0, y0, z0, _, _, z1), (vx, vy) = v["pc_range"], v["voxel_size"][:2]
        dev = pts.device
        vsize = torch.tensor([vx, vy], dtype=pts.dtype, device=dev)
        ix = torch.floor((pts[:, 0] - x0) / vsize[0]).to(torch.int64)
        iy = torch.floor((pts[:, 1] - y0) / vsize[1]).to(torch.int64)
        ok = (valid & (ix >= 0) & (ix < W) & (iy >= 0) & (iy < H)
              & (pts[:, 2] >= z0) & (pts[:, 2] <= z1))
        n_seg = H * W + 1
        pid = torch.where(ok, iy * W + ix, torch.full_like(ix, n_seg - 1))
        w = ok.to(pts.dtype)[:, None]
        sums = pts.new_zeros((n_seg, 4)).index_add_(
            0, pid, torch.cat([pts[:, :3] * w, w], -1))
        g = sums[pid]
        f_cluster = pts[:, :3] - g[:, :3] / torch.clamp_min(g[:, 3:], 1.0)
        cx = ix.to(pts.dtype) * vx + (vx / 2 + x0)
        cy = iy.to(pts.dtype) * vy + (vy / 2 + y0)
        x = torch.cat([pts, f_cluster, torch.stack([pts[:, 0] - cx,
                                                    pts[:, 1] - cy], -1)],
                      -1) * w
        floor = self.cap > 0
        fm = g[:, 3:] < float(self.cap)
        phantom = x.new_zeros((1, x.shape[-1]))
        for i, layer in enumerate(self.pfn_layers):
            y = layer.linear(x)
            norm = layer.norm
            if norm.training:
                raise ValueError("the reference's pillar reader runs in eval")
            x = torch.relu(norm(y))
            ph = torch.relu(norm(layer.linear(phantom)))
            x_eff = x
            if floor:
                ph_pt = ph if ph.shape[0] == 1 else ph[pid]
                x_eff = torch.where(fm, torch.maximum(x, ph_pt), x)
            pool_in = torch.where(ok[:, None], x_eff, float("-inf"))
            pooled = pool_in.new_full((n_seg, x.shape[1]), float("-inf"))
            pooled.scatter_reduce_(0, pid[:, None].expand_as(pool_in),
                                   pool_in, "amax", include_self=False)
            pooled = torch.where(torch.isfinite(pooled), pooled, 0.0)
            if i < len(self.pfn_layers) - 1:
                x = torch.cat([x, pooled[pid]], -1)
                phantom = torch.cat([ph.expand(n_seg, ph.shape[-1]), pooled],
                                    -1)
        return pooled[:H * W].reshape(1, H, W, -1)


class PointPillars(nn.Module):
    def __init__(self, e: Dict):
        super().__init__()
        m = e["model"]
        self.reader = PillarReader(m, e["voxel"])
        self.neck = RPN(m["pillar_filters"][-1], m["rpn"])
        self.bbox_head = CenterHead(m["head"])

    def forward(self, points, valid):
        canvas = self.reader(points[0], valid[0])
        return self.bbox_head(self.neck(canvas.permute(0, 3, 1, 2)))


def build_empty(experiment: Dict, device) -> nn.Module:
    """`build`'s model on `device`, for a state dict to be loaded over
    its initial values. Not made on the meta device: the first move of
    meta tensors to a device costs some seconds of torch's lazy imports."""
    with torch.device(device):
        return build(experiment)


def build(experiment: Dict) -> nn.Module:
    det = experiment["model"]["detector"]
    if det == "voxelnet":
        if experiment["model"]["middle"] != "sparse":
            raise ValueError("the reference runs the sparse middle")
        return VoxelNet(experiment)
    if det == "pointpillars":
        return PointPillars(experiment)
    raise ValueError(f"unknown detector {det!r}")


def dense_layers(model: nn.Module):
    """The dense layers whose products a forward computes: every Conv2d,
    ConvTranspose2d and Linear."""
    return [m for m in model.modules()
            if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear))]
