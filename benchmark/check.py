"""How `correct` is decided: the program's outputs from the timed window,
judged by the plain reference (`benchmark/reference/`), which recomputes
everything from the same inputs and weights.

Stream cells, for a sample of the scenes that the window served:

  maps_rel  every head map of every task against the reference's, the
            largest |program - reference| over max(1, max |reference|)
            of a map: voxelize or the pillar reader, the sparse middle
            with K2, the neck and the head;
  det_gap   each detection the program returned, against the nearest
            reference candidate of its task (the decoded box of one cell
            of the reference's maps): the largest |program - reference| /
            max(1, |reference|) of a box field or the score, and the angle's
            gap times the length of the rot vector it is the angle of (at
            most 1), over the detections;
  nms_gap   the survivors against greedy NMS, judged with the reference's
            IoU: no two survivors of a task overlap by more than the
            threshold, and every candidate that scores above the task's
            lowest survivor (the threshold where fewer than `post_max`
            survive) and within the reference's top `pre_max` is a
            survivor or overlaps a survivor of at least its score by more
            than the threshold. The number is the largest shortfall; a
            score within `score_tie` of another counts as equal.

Training cells, over the first steps, which the window's own call ran:

  loss_gap           |loss - reference loss| / |reference loss| of the
                     first step (`loss_gap_any_step`: the worst step);
  grad_gap           the first gradient as AdamW got it (its first moment
                     after one step over 1 - b1), worst leaf: the gap
                     between the two norms over the larger of the
                     reference's norm of that leaf and of the median leaf.
                     Every leaf counts, the sparse middle's (K2's dx and
                     dW) among them; `grad_gap_median` is the median leaf;
  update_gap_median  the same of each parameter's change over the steps,
                     median leaf (`update_gap`: the worst), leaving out
                     leaves whose reference gradient lies under 1e-3 of
                     the median leaf's (AdamW moves them by round-off
                     alone).

Which of these numbers a cell compares, and each limit, is the cell's
`limits/<workload>.json`; the others are printed as not compared.
"""
from __future__ import annotations

import math
import statistics
from typing import Dict, List

import torch

from .reference.detect import candidates, iou_bev, nms_frame

# a parameter whose reference gradient is under this share of the median
# leaf's is moved by round-off alone under AdamW
ZERO_GRAD_SHARE = 1e-3
# scores that lie this close count as tied in the NMS judgement: 50 times
# the largest score gap between the program and the reference measured on
# the card (2e-6, NVIDIA H100 80GB HBM3)
SCORE_TIE = 1e-4


def maps_rel(prog: List[Dict[str, torch.Tensor]],
             ref: List[Dict[str, torch.Tensor]]) -> float:
    worst = 0.0
    for p, r in zip(prog, ref):
        for k, rv in r.items():
            pv = p[k].to(rv.device, rv.dtype)
            scale = max(1.0, float(rv.abs().max()))
            worst = max(worst, float((pv - rv).abs().max()) / scale)
    return worst


def _fields(boxes, scores):
    """(N, 9): the 8 box fields but the angle, and the score."""
    return torch.cat([boxes[:, :8], scores[:, None]], -1)


def _nearest(p: torch.Tensor, r: torch.Tensor, chunk: int = 4096):
    """For each row of p (n, F), the distance to the nearest row of r (m,
    F) and its index: the largest |p - r| / max(1, |r|) over the fields."""
    best = torch.full((p.shape[0],), float("inf"), device=r.device)
    arg = torch.zeros(p.shape[0], dtype=torch.int64, device=r.device)
    for a in range(0, r.shape[0], chunk):
        rc = r[None, a:a + chunk, :]
        d = ((p[:, None, :] - rc).abs() / rc.abs().clamp_min(1.0)).amax(-1)
        v, i = d.min(1)
        better = v < best
        best = torch.where(better, v, best)
        arg = torch.where(better, i + a, arg)
    return best, arg


def judge_scene(experiment: Dict, prog_det, ref_preds,
                score_tie: float = SCORE_TIE) -> Dict[str, float]:
    """({det_gap, nms_gap}, the worst detection's fields on both sides) of
    one scene: `prog_det` the program's (boxes (1, T*post, 9), scores,
    labels, valid) on the host, `ref_preds` the reference's maps."""
    t_cfg = experiment["test"]
    post, pre = t_cfg["nms"]["post_max_size"], t_cfg["nms"]["pre_max_size"]
    thr = t_cfg["nms"]["iou_threshold"]
    boxes, scores, labels, valid = (t[0] for t in prog_det)
    det_gap = nms_gap = 0.0
    worst = None
    for t, pd in enumerate(ref_preds):
        rb, rs, top, order = candidates(experiment, pd)
        dev = rb.device
        sl = slice(t * post, (t + 1) * post)
        keep = valid[sl]
        pb = boxes[sl][keep].to(dev)
        ps = scores[sl][keep].to(dev)
        if (labels[sl][keep] != t).any():
            return {"det_gap": math.inf, "nms_gap": math.inf}, {
                "task": t, "labels": labels[sl][keep].tolist()}
        rfield = _fields(rb, rs)
        pfield = _fields(pb, ps)
        gap, cell = _nearest(pfield, rfield)
        # the angle, atan2 of the rot map's two channels, is as sharp as
        # that vector is short: its gap is weighed by the vector's length
        rot_len = torch.linalg.vector_norm(pd["rot"][0].reshape(-1, 2), dim=-1)
        turn = torch.remainder(pb[:, 8] - rb[cell, 8] + math.pi,
                               2 * math.pi) - math.pi
        gap = torch.maximum(gap, turn.abs() * rot_len[cell].clamp_max(1.0))
        if len(pb) and float(gap.max()) > det_gap:
            det_gap = float(gap.max())
            j = int(gap.argmax())
            worst = {"task": t, "program": pb[j].tolist() + [float(ps[j])],
                     "reference": rb[cell[j]].tolist() + [float(rs[cell[j]])]}
        kept_frame = nms_frame(pb)
        # survivors overlap no more than the threshold
        if len(pb) > 1:
            iou = iou_bev(kept_frame, kept_frame)
            iou.fill_diagonal_(0.0)
            nms_gap = max(nms_gap, float(iou.max()) - thr)
        # every strong candidate survives or is removed by a survivor
        floor = float(top[-1]) if len(top) == pre else -math.inf
        cut = float(ps.min()) if len(pb) == post else -math.inf
        need = torch.isfinite(top) & (top > max(floor, cut) + score_tie)
        need[torch.isin(order, cell)] = False
        if need.any():
            c = order[need]
            cb = nms_frame(rb[c])
            ov = iou_bev(kept_frame, cb) if len(pb) else \
                torch.zeros(0, len(c), device=dev)
            higher = rs[cell][:, None] >= rs[c][None, :] - score_tie
            best = torch.where(higher, ov, 0.0).amax(0) if len(pb) else \
                torch.zeros(len(c), device=dev)
            nms_gap = max(nms_gap, float((thr - best).max()))
    return {"det_gap": det_gap, "nms_gap": max(nms_gap, 0.0)}, worst


def _leaf_gaps(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
               leaves) -> List[float]:
    """Per leaf, |program norm - reference norm| over the larger of the
    reference's norm of that leaf and of the median leaf."""
    pn = {k: float(prog[k].double().norm()) for k in leaves}
    rn = {k: float(ref[k].double().norm()) for k in leaves}
    med = statistics.median(rn.values())
    return [abs(pn[k] - rn[k]) / max(rn[k], med, 1e-30) for k in leaves]


def train_numbers(prog: Dict, ref: Dict) -> Dict[str, float]:
    """`prog` and `ref` each: "losses" [float] a step, "grads" and
    "updates" {name: tensor}. The first step's loss, the first gradient
    and the change over the steps, each by its worst leaf and by the
    median leaf; the worst step's loss."""
    names = list(ref["grads"])
    gnorm = {k: float(ref["grads"][k].double().norm()) for k in names}
    med = statistics.median(gnorm.values())
    moved = [k for k in names if gnorm[k] >= ZERO_GRAD_SHARE * med]
    grads = _leaf_gaps(prog["grads"], ref["grads"], names)
    updates = _leaf_gaps(prog["updates"], ref["updates"], moved)
    losses = [abs(p - r) / abs(r)
              for p, r in zip(prog["losses"], ref["losses"])]
    return {"loss_gap": losses[0], "loss_gap_any_step": max(losses),
            "grad_gap": max(grads), "grad_gap_median": statistics.median(grads),
            "update_gap": max(updates),
            "update_gap_median": statistics.median(updates)}


def train_detail(prog: Dict, ref: Dict, n: int = 5) -> Dict:
    """Each side's losses, and the leaves whose gradient and update norms
    lie furthest apart (norms of the program, of the reference)."""
    def worst(key):
        rows = []
        for k in ref[key]:
            pn, rn = (float(x[key][k].double().norm()) for x in (prog, ref))
            rows.append((abs(pn - rn), k, pn, rn))
        return [r[1:] for r in sorted(rows, reverse=True)[:n]]
    return {"losses": [prog["losses"], ref["losses"]],
            "grads": worst("grads"), "updates": worst("updates")}
