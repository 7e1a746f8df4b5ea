"""Collectives over `torch.distributed`: process-group bring-up, the
statistics and gradient reductions of a data-parallel or spatially sharded
train step, the halo exchange and band gather of a spatially sharded
canvas, and fixed-shape gathers of evaluation results.

Port of `futuredet_tpu/parallel/collectives.py` and of the collectives
that the JAX step runs under `shard_map` over its `data` axis
(`futuredet_tpu/train/step.py:139-160`, the BatchNorms' `axis_name`) or
that XLA's SPMD partitioner inserts for its `space` axis (`step.py:179-
233`):

  * `initialize_multihost` -> `torch.distributed.init_process_group` at
    `tcp://<coordinator_address>`, NCCL for a card, gloo for the CPU;
  * `pmean` is `jax.lax.pmean` with its gradient: a differentiable
    all-reduce, whose backward all-reduces the cotangent, divided by the
    group's size, as JAX transposes `pmean` (the statistics of every
    BatchNorm carry gradient across ranks); `psum` the same without the
    division;
  * `average_gradients_` is the step's `pmean(grads)`: one flat
    all-reduce over every gradient (under `--space`, the sum over the
    space group and the mean over the data group);
  * `halo_rows` gives a band of canvas rows the rows of its neighbours
    that a conv window reaches (point-to-point, with the transpose in its
    backward), `gather_rows` the whole canvas from its bands (its
    backward hands each rank the cotangent of its own rows);
  * `gather_detections` and `gather_eval_batch` replace
    `process_allgather`: fixed-shape `all_gather`s concatenated along the
    batch in rank order, with the JAX encoding of tokens and GT
    (`encode_tokens`, `_encode_gt`).

Every function takes its process group (default: the world). Without a
process group, or in a group of one rank, every function is the identity
(`gather_eval_batch` an encode / decode round trip), so the
single-process path runs as before. Under gloo a collective stages a
card's tensors through the host.
"""
from __future__ import annotations

import datetime
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None,
                         device: Optional[torch.device] = None) -> int:
    """Join the process group of `num_processes` ranks at
    `tcp://<coordinator_address>` (host:port; rank `process_id` 0 listens
    there) as rank `process_id`: NCCL when `device` is a card, whose index
    becomes `process_id` modulo the cards of this host, gloo on the CPU.
    A no-op without an address. Returns the world size."""
    if coordinator_address is None:
        return world_size()
    if num_processes is None or process_id is None:
        raise ValueError("--coordinator_address needs --num_processes and "
                         "--process_id")
    if not 0 <= process_id < num_processes:
        raise ValueError(f"--process_id {process_id} is outside [0, "
                         f"{num_processes})")
    on_card = device is not None and torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    dist.init_process_group(
        "nccl" if on_card else "gloo",
        init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id,
        timeout=datetime.timedelta(minutes=10))
    return world_size()


def leave(coordinator_address: Optional[str] = None) -> None:
    """Leave the process group that `initialize_multihost` joined at
    `coordinator_address` (nothing without an address)."""
    if coordinator_address is not None and dist.is_initialized():
        dist.destroy_process_group()


def world_size(group=None) -> int:
    """Ranks of `group` (default: the world), 1 without a process
    group."""
    return dist.get_world_size(group) if dist.is_initialized() else 1


def rank() -> int:
    """This process's rank, 0 without a process group."""
    return dist.get_rank() if dist.is_initialized() else 0


def _collective_device(t: torch.Tensor, group=None) -> torch.device:
    """Where a collective of `group` runs: NCCL takes the card's tensors,
    gloo the CPU's."""
    if dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """A new tensor on x's device: x summed over `group`'s ranks."""
    w = x.detach().to(_collective_device(x, group), copy=True)
    dist.all_reduce(w, group=group)
    return w.to(x.device)


class _AllReduceSum(torch.autograd.Function):
    """The sum over a group and its transpose, the sum of the cotangents.
    The staging through the host stays inside the node: a node on a
    host tensor would run on autograd's CPU thread, beside the card's, so
    that two ranks could reach their collectives in different orders."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce_sum(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce_sum(g.contiguous(), ctx.group), None


def psum(*tensors: torch.Tensor, group=None) -> List[torch.Tensor]:
    """The sum of each tensor over the ranks of `group`, differentiable
    (one all-reduce of their concatenation, whose backward all-reduces the
    cotangent): `jax.lax.psum` and its transpose. The identity in a group
    of one rank."""
    if world_size(group) == 1:
        return list(tensors)
    flat = _AllReduceSum.apply(torch.cat([t.reshape(-1) for t in tensors]),
                               group)
    out, i = [], 0
    for t in tensors:
        out.append(flat[i:i + t.numel()].view(t.shape))
        i += t.numel()
    return out


def pmean(*tensors: torch.Tensor, group=None) -> List[torch.Tensor]:
    """The mean of each tensor over the ranks of `group`, differentiable:
    `jax.lax.pmean` and its transpose. The identity in a group of one
    rank."""
    n = world_size(group)
    return [t / n for t in psum(*tensors, group=group)] if n > 1 \
        else list(tensors)


def average_gradients_(params: Sequence[torch.Tensor], space=None) -> None:
    """In place: every `.grad` of `params` becomes its mean over the ranks,
    in one all-reduce of the gradients flattened into one buffer. Under a
    `parallel/mesh.py::SpaceGroup` each rank's gradient is its band's
    share of its space group's, so the gradient becomes the sum over the
    space group and the mean over the data group: the all-reduce over the
    world divided by the data width. Every rank must hold gradients for
    the same parameters. Nothing on one rank."""
    n = world_size()
    if n == 1:
        return
    grads = [p.grad for p in params if p.grad is not None]
    flat = torch.cat([g.reshape(-1) for g in grads])
    home = flat.device
    flat = flat.to(_collective_device(flat))
    dist.all_reduce(flat)
    flat = flat.to(home).div_(n if space is None else space.n_data)
    i = 0
    for g in grads:
        g.copy_(flat[i:i + g.numel()].view(g.shape))
        i += g.numel()


# ---------------------------------------------------------------------------
# The spatially sharded canvas (`parallel/mesh.py::SpaceGroup`): each rank
# of a space group holds a band of rows of an NCHW (or, for the gather, any)
# tensor; the collectives XLA inserts for a sharding constraint on rows.
# ---------------------------------------------------------------------------

# what the halo exchanges of this process moved (forward and backward):
# calls, and bytes this rank sent
HALO_STATS = {"exchanges": 0, "bytes": 0}


def reset_halo_stats() -> None:
    HALO_STATS.update(exchanges=0, bytes=0)


def _wire(t: torch.Tensor, group) -> torch.Tensor:
    """`t` contiguous on the device of `group`'s collectives."""
    return t.to(_collective_device(t, group)).contiguous()


def _swap(space, to_above: torch.Tensor, to_below: torch.Tensor,
          from_above: int, from_below: int):
    """One exchange with the two space neighbours: `to_above` (rows) goes
    to the band above, `to_below` to the band below; `from_above` rows
    come from the band above and `from_below` from the band below, each
    None at the canvas's edge (or for 0 rows). The tensors are NCHW bands
    with rows on dim 2."""
    group = space.space
    ops, recv = [], {}
    for peer, send, n_in, key in ((space.above, to_above, from_above, "a"),
                                  (space.below, to_below, from_below, "b")):
        if peer is None:
            continue
        if send.shape[2]:
            w = _wire(send, group)
            ops.append(dist.P2POp(dist.isend, w, peer, group))
            HALO_STATS["bytes"] += w.numel() * w.element_size()
        if n_in:
            shape = (*send.shape[:2], n_in, send.shape[3])
            buf = torch.empty(shape, dtype=send.dtype,
                              device=_collective_device(send, group))
            ops.append(dist.P2POp(dist.irecv, buf, peer, group))
            recv[key] = buf
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    HALO_STATS["exchanges"] += 1
    dev = to_above.device
    return tuple(recv[k].to(dev) if k in recv else None for k in ("a", "b"))


class _HaloRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, top, bot, space):
        ctx.top, ctx.bot, ctx.space = top, bot, space
        n = x.shape[2]
        a, b = _swap(space, x[:, :, :bot], x[:, :, n - top:], top, bot)
        B, C, _, W = x.shape
        a = x.new_zeros((B, C, top, W)) if a is None else a
        b = x.new_zeros((B, C, bot, W)) if b is None else b
        return torch.cat([a, x, b], 2)

    @staticmethod
    def backward(ctx, g):
        top, bot = ctx.top, ctx.bot
        n = g.shape[2] - top - bot
        # each halo's cotangent goes back to the band it came from, which
        # adds it to its boundary rows
        a, b = _swap(ctx.space, g[:, :, :top], g[:, :, top + n:], bot, top)
        dx = g[:, :, top:top + n].clone()
        if a is not None:
            dx[:, :, :bot] += a
        if b is not None:
            dx[:, :, n - top:] += b
        return dx, None, None, None


def halo_rows(x: torch.Tensor, top: int, bot: int, space) -> torch.Tensor:
    """An NCHW band of rows with `top` rows of the band above before it and
    `bot` rows of the band below after it, zeros beyond the canvas's
    edges (a conv's own zero padding); differentiable. `x` as it is when
    both are 0. A band must hold at least max(top, bot) rows."""
    if not (top or bot):
        return x
    if x.shape[2] < max(top, bot):
        raise ValueError(f"a band of {x.shape[2]} rows cannot give a halo "
                         f"of {max(top, bot)}")
    return _HaloRows.apply(x, top, bot, space)


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, bands, space):
        ctx.dim, ctx.band = dim, bands[space.index]
        widest = max(b - a for a, b in bands)
        pad = list(x.shape)
        pad[dim] = widest - x.shape[dim]
        w = _wire(torch.cat([x, x.new_zeros(pad)], dim), space.space)
        parts = [torch.empty_like(w) for _ in bands]
        dist.all_gather(parts, w, group=space.space)
        return torch.cat([p.to(x.device).narrow(dim, 0, b - a)
                          for p, (a, b) in zip(parts, bands)], dim)

    @staticmethod
    def backward(ctx, g):
        # every rank computes the same loss on the gathered maps, so each
        # rank's cotangent is the whole one: its own rows are its band's
        a, b = ctx.band
        return g.narrow(ctx.dim, a, b - a).contiguous(), None, None, None


def gather_rows(x: torch.Tensor, dim: int, bands, space) -> torch.Tensor:
    """The whole tensor on every rank of the space group from each rank's
    band along `dim` (`bands`: every rank's [start, stop), by space
    index), differentiable: the backward gives each rank the cotangent of
    its own rows (not the sum over the ranks, which would count a loss
    that every rank computes once per rank)."""
    return _GatherRows.apply(x, dim, bands, space)


def _all_gather_np(a: np.ndarray, group=None) -> np.ndarray:
    """Concatenate every rank's array of `group` along axis 0, in rank
    order. Every rank passes the same shape past axis 0 (axis 0 too: the
    eval shards are equal)."""
    a = np.ascontiguousarray(a)
    wire = a.view(np.uint8) if a.dtype == np.bool_ else a
    t = torch.from_numpy(wire)
    t = t.to(_collective_device(t, group))
    parts = [torch.empty_like(t) for _ in range(world_size(group))]
    dist.all_gather(parts, t, group=group)
    out = torch.cat(parts).cpu().numpy()
    return out.view(np.bool_) if a.dtype == np.bool_ else out


def gather_detections(det, group=None):
    """A per-rank detection tuple (fixed shapes, leading batch dim) on the
    host, concatenated across the ranks of `group` along the batch: the
    JAX `process_allgather(..., tiled=True)`. One rank: the host copy."""
    host = type(det)(*(np.asarray(x.detach().cpu()) if
                       isinstance(x, torch.Tensor) else np.asarray(x)
                       for x in det))
    if world_size(group) == 1:
        return host
    return type(det)(*(_all_gather_np(x, group) for x in host))


# ---------------------------------------------------------------------------
# The eval payload (futuredet_tpu/parallel/collectives.py:48-114): tokens,
# attribute names and keyframe times become fixed-shape arrays, so that one
# gather moves a batch.
# ---------------------------------------------------------------------------

# nuScenes attribute vocabulary (index 0: no attribute), fixed so that every
# rank encodes alike
NUSC_ATTRS = (
    "", "cycle.with_rider", "cycle.without_rider", "pedestrian.moving",
    "pedestrian.sitting_lying_down", "pedestrian.standing", "vehicle.moving",
    "vehicle.parked", "vehicle.stopped",
)
_ATTR_ID = {a: i for i, a in enumerate(NUSC_ATTRS)}
_TOKEN_WIDTH = 64


def encode_tokens(tokens) -> np.ndarray:
    """Sample tokens -> (B, 64) uint8 (utf-8, zero-padded)."""
    out = np.zeros((len(tokens), _TOKEN_WIDTH), np.uint8)
    for i, t in enumerate(tokens):
        raw = t.encode("utf-8")[:_TOKEN_WIDTH]
        out[i, :len(raw)] = np.frombuffer(raw, np.uint8)
    return out


def decode_tokens(arr: np.ndarray) -> List[str]:
    return [bytes(row[row != 0]).decode("utf-8") for row in np.asarray(arr)]


def _encode_gt(gt: Dict, times_width: Optional[int] = None) -> Dict:
    """GT dict -> arrays: attribute names as vocabulary ids, keyframe times
    as NaN-padded rows `times_width` wide (default: the longest here)."""
    enc = {k: np.asarray(gt[k]) for k in ("boxes", "valid", "classes", "traj")
           if gt.get(k) is not None}
    if gt.get("attr") is not None:
        enc["attr"] = np.asarray(
            [[_ATTR_ID.get(str(a), 0) for a in row] for row in gt["attr"]],
            np.int32)
    times = gt.get("times")
    if times is not None and any(t is not None for t in times):
        L = times_width or max(len(t) for t in times if t is not None)
        tarr = np.full((len(times), L), np.nan, np.float32)
        for i, t in enumerate(times):
            if t is not None:
                tarr[i, :len(t)] = np.asarray(t, np.float32)
        enc["times"] = tarr
    return enc


def _decode_gt(enc: Dict) -> Dict:
    gt = {k: enc[k] for k in ("boxes", "valid", "classes", "traj")
          if k in enc}
    if "attr" in enc:
        gt["attr"] = np.array(
            [[NUSC_ATTRS[i] for i in row] for row in enc["attr"]], object)
    if "times" in enc:
        gt["times"] = [row[~np.isnan(row)] for row in enc["times"]]
    return gt


def _times_width(gt: Dict, group=None) -> Optional[int]:
    """The longest keyframe-time row over every rank of `group` (None
    without times): the width that makes the times array's shape the same
    on all its ranks."""
    times = gt.get("times")
    have = times is not None and any(t is not None for t in times)
    L = max(len(t) for t in times if t is not None) if have else -1
    t = torch.tensor([L])
    t = t.to(_collective_device(t, group))
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
    L = int(t)
    return None if L < 0 else L


def gather_eval_batch(det, gt: Dict, tokens, group=None):
    """One eval batch's (detections, GT dict, sample tokens) from every
    rank of `group` (default: the world), concatenated along the batch in
    rank order, on the host. Every rank must evaluate the same number of
    batches of the same size (the strided shards of
    `batches_from_dataset`). One rank: an encode / decode round trip."""
    n = world_size(group)
    det = gather_detections(det, group)
    enc = _encode_gt(gt, _times_width(gt, group) if n > 1 else None)
    tok = encode_tokens(tokens)
    if n > 1:
        enc = {k: _all_gather_np(v, group) for k, v in enc.items()}
        tok = _all_gather_np(tok, group)
    return det, _decode_gt(enc), decode_tokens(tok)
