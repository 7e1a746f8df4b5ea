"""Data-parallel collectives over `torch.distributed`: process-group
bring-up, the statistics and gradient means of a data-parallel train step,
and fixed-shape gathers of evaluation results.

Port of `futuredet_tpu/parallel/collectives.py` and of the collectives
that the JAX step runs under `shard_map` over its `data` axis
(`futuredet_tpu/train/step.py:139-160`, the BatchNorms' `axis_name`):

  * `initialize_multihost` -> `torch.distributed.init_process_group` at
    `tcp://<coordinator_address>`, NCCL for a card, gloo for the CPU;
  * `pmean` is `jax.lax.pmean` with its gradient: a differentiable
    all-reduce (`torch.distributed.nn.functional.all_reduce`), whose
    backward all-reduces the cotangent, divided by the world size, as
    JAX transposes `pmean` (the statistics of every BatchNorm carry
    gradient across ranks);
  * `average_gradients_` is the step's `pmean(grads)`: one flat
    all-reduce over every gradient;
  * `gather_detections` and `gather_eval_batch` replace
    `process_allgather`: fixed-shape `all_gather`s concatenated along the
    batch in rank order, with the JAX encoding of tokens and GT
    (`encode_tokens`, `_encode_gt`).

Without a process group, or with one rank, every function is the
identity (`gather_eval_batch` an encode / decode round trip), so the
single-process path runs as before.
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


def world_size() -> int:
    """Ranks of the default process group, 1 without one."""
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    """This process's rank, 0 without a process group."""
    return dist.get_rank() if dist.is_initialized() else 0


def _collective_device(t: torch.Tensor) -> torch.device:
    """Where a collective of the default group runs: NCCL takes the card's
    tensors, gloo the CPU's."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def pmean(*tensors: torch.Tensor) -> List[torch.Tensor]:
    """The mean of each tensor over the ranks, differentiable (one
    all-reduce of their concatenation): `jax.lax.pmean` and its
    transpose. The identity on one rank."""
    n = world_size()
    if n == 1:
        return list(tensors)
    from torch.distributed.nn.functional import all_reduce
    flat = torch.cat([t.reshape(-1) for t in tensors])
    home = flat.device
    flat = all_reduce(flat.to(_collective_device(flat))).to(home) / n
    out, i = [], 0
    for t in tensors:
        out.append(flat[i:i + t.numel()].view(t.shape))
        i += t.numel()
    return out


def average_gradients_(params: Sequence[torch.Tensor]) -> None:
    """In place: every `.grad` of `params` becomes its mean over the ranks,
    in one all-reduce of the gradients flattened into one buffer. Every
    rank must hold gradients for the same parameters. Nothing on one
    rank."""
    n = world_size()
    if n == 1:
        return
    grads = [p.grad for p in params if p.grad is not None]
    flat = torch.cat([g.reshape(-1) for g in grads])
    home = flat.device
    flat = flat.to(_collective_device(flat))
    dist.all_reduce(flat)
    flat = flat.to(home).div_(n)
    i = 0
    for g in grads:
        g.copy_(flat[i:i + g.numel()].view(g.shape))
        i += g.numel()


def _all_gather_np(a: np.ndarray) -> np.ndarray:
    """Concatenate every rank's array along axis 0, in rank order. Every
    rank passes the same shape past axis 0 (axis 0 too: the eval shards
    are equal)."""
    a = np.ascontiguousarray(a)
    wire = a.view(np.uint8) if a.dtype == np.bool_ else a
    t = torch.from_numpy(wire)
    t = t.to(_collective_device(t))
    parts = [torch.empty_like(t) for _ in range(world_size())]
    dist.all_gather(parts, t)
    out = torch.cat(parts).cpu().numpy()
    return out.view(np.bool_) if a.dtype == np.bool_ else out


def gather_detections(det):
    """A per-rank detection tuple (fixed shapes, leading batch dim) on the
    host, concatenated across ranks along the batch: the JAX
    `process_allgather(..., tiled=True)`. One rank: the host copy."""
    host = type(det)(*(np.asarray(x.detach().cpu()) if
                       isinstance(x, torch.Tensor) else np.asarray(x)
                       for x in det))
    if world_size() == 1:
        return host
    return type(det)(*(_all_gather_np(x) for x in host))


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


def _times_width(gt: Dict) -> Optional[int]:
    """The longest keyframe-time row over every rank (None without
    times): the width that makes the times array's shape the same on all
    ranks."""
    times = gt.get("times")
    have = times is not None and any(t is not None for t in times)
    L = max(len(t) for t in times if t is not None) if have else -1
    t = torch.tensor([L])
    t = t.to(_collective_device(t))
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    L = int(t)
    return None if L < 0 else L


def gather_eval_batch(det, gt: Dict, tokens):
    """One eval batch's (detections, GT dict, sample tokens) from every
    rank, concatenated along the batch in rank order, on the host. Every
    rank must evaluate the same number of batches of the same size (the
    strided shards of `batches_from_dataset`). One rank: an encode /
    decode round trip."""
    n = world_size()
    det = gather_detections(det)
    enc = _encode_gt(gt, _times_width(gt) if n > 1 else None)
    tok = encode_tokens(tokens)
    if n > 1:
        enc = {k: _all_gather_np(v) for k, v in enc.items()}
        tok = _all_gather_np(tok)
    return det, _decode_gt(enc), decode_tokens(tok)
