"""Many-to-one trajectory linking: the FutureDet post-detection association.

The port's copy of `futuredet_tpu/eval/linking.py`, a behavioural port of
the host-side linking in the reference's
det3d/datasets/nuscenes/nuscenes.py:
  match_boxes()   :112-123  nearest-center per-timestep matching
  tracker()       :125-257  forward chains by velocity-extrapolated matching,
                            constant-velocity fallbacks, and backcast chains
  multi_future()  :299-339  group trajectories sharing a start (<0.25 m) into
                            forecast_id via connected components
  trajectory_score() :495-508  first/last/add/mult re-ranking

Works on the host arrays of eval.decode.Detections: per sample, per timestep
t the detections with label == t are that timestep's future-detection set.
Host numpy (post-NMS sets are <= 83 boxes x 7 timesteps).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence

import numpy as np

REJECT_THRESH = {"car": 2.0, "pedestrian": 1.0}
MATCH_THRESH = 0.25


@dataclass
class Trajectory:
    """One linked trajectory: boxes (T, 9) [x,y,z,w,l,h,vx,vy,yaw] and the
    per-timestep detection scores used for re-ranking."""
    boxes: np.ndarray
    scores: np.ndarray
    forecast_id: int = -1

    @property
    def det_score(self) -> float:
        return float(self.scores[0])


def split_by_timestep(boxes, scores, labels, valid, timesteps: int):
    """Detections arrays (N, ...) -> per-timestep lists (ref :401-411)."""
    out = []
    for t in range(timesteps):
        m = valid & (labels == t)
        out.append((boxes[m], scores[m]))
    return out


def _dist_matrix(a, b):
    return np.linalg.norm(a[:, None, :] - b[None, :, :], axis=-1)


def match_boxes(per_t):
    """Nearest-center match of every timestep's boxes to t=0's boxes
    (ref :112-123). Returns list of Trajectory (constant ordering by t0)."""
    b0 = per_t[0][0]
    if len(b0) == 0:
        return []
    trajs = []
    matched = []
    for bt, st in per_t:
        if len(bt) == 0:
            matched.append((b0, per_t[0][1]))
            continue
        idx = np.argmin(_dist_matrix(b0[:, :2], bt[:, :2]), axis=1)
        matched.append((bt[idx], st[idx]))
    for j in range(len(b0)):
        trajs.append(Trajectory(
            boxes=np.stack([m[0][j] for m in matched]),
            scores=np.array([m[1][j] for m in matched])))
    return trajs


def tracker(classname: str, times: Sequence[float], per_t) -> List[Trajectory]:
    """Many-to-one dense linking (ref :125-257): forward association chains,
    constant-velocity fallbacks, and backcast chains from future detections."""
    reject = REJECT_THRESH.get(classname, 2.0)
    T = len(per_t)
    trajs: List[Trajectory] = []

    def chains(seq, seq_times, extrapolate_sign):
        """Greedy per-step association of consecutive sets; returns index
        chains starting from every box of seq[0], or None when any timestep
        is empty (the reference aborts the WHOLE tracker in that case,
        ref :158-159, :212-213)."""
        idx_steps, dist_steps = [], []
        for t in range(T - 1):
            cur_b, _ = seq[t]
            nxt_b, _ = seq[t + 1]
            if len(cur_b) == 0 or len(nxt_b) == 0:
                continue
            pred = cur_b[:, :2] + extrapolate_sign * seq_times[t] * cur_b[:, 6:8]
            d = _dist_matrix(pred, nxt_b[:, :2])
            idx_steps.append(np.argmin(d, axis=1))
            dist_steps.append(np.min(d, axis=1))
        if len(idx_steps) != T - 1:
            return None
        out = []
        n0 = len(seq[0][0])
        for i in range(n0):
            chain = [i]
            void = False
            for ind, dis in zip(idx_steps, dist_steps):
                if dis[chain[-1]] > reject:
                    void = True
                chain.append(ind[chain[-1]])
            if not void:
                out.append(chain)
        return out

    if classname in ("car", "pedestrian"):
        # forward chains; an empty timestep aborts the whole tracker
        # (ref :158-159 returns [] before the fallbacks run)
        fwd = chains(per_t, list(times), +1.0)
        if fwd is None:
            return []
        for chain in fwd:
            trajs.append(Trajectory(
                boxes=np.stack([per_t[t][0][j] for t, j in enumerate(chain)]),
                scores=np.array([per_t[t][1][j] for t, j in enumerate(chain)])))

        # constant-velocity forward (every t0 box; ref :182-192 — note the
        # reference appends T+1 boxes [curr + T extrapolations]; we keep the
        # T-length convention by extrapolating T-1 steps)
        b0, s0 = per_t[0]
        for j in range(len(b0)):
            boxes = [b0[j].copy()]
            for t in range(T - 1):
                nb = boxes[-1].copy()
                nb[:2] = nb[:2] + times[t] * b0[j][6:8]
                boxes.append(nb)
            trajs.append(Trajectory(boxes=np.stack(boxes),
                                    scores=np.full(T, s0[j])))

        # backcast chains: associate backwards from the future (ref :194-234)
        rev = per_t[::-1]
        rev_times = list(times)[::-1]
        bwd = chains(rev, rev_times, -1.0)
        if bwd is None:
            return []
        for chain in bwd:
            boxes = [rev[t][0][j] for t, j in enumerate(chain)][::-1]
            scores = [rev[t][1][j] for t, j in enumerate(chain)][::-1]
            trajs.append(Trajectory(boxes=np.stack(boxes),
                                    scores=np.array(scores)))
    return trajs


def constant_velocity_trajectories(per_t, times, reverse: bool = False):
    """velocity_constant / velocity_forward / velocity_reverse modes
    (ref :440-460): nearest-center matched boxes, then extrapolate t0's box
    with each timestep's matched velocity."""
    matched = match_boxes(per_t)
    T = len(per_t)
    out = []
    tms = list(times)[::-1] if reverse else list(times)
    for tr in matched:
        boxes = [tr.boxes[0].copy()]
        for i in range(T - 1):
            nb = boxes[-1].copy()
            sign = -1.0 if reverse else 1.0
            nb[:2] = nb[:2] + sign * tms[i] * tr.boxes[i][6:8]
            boxes.append(nb)
        if reverse:
            boxes = boxes[::-1]
        out.append(Trajectory(boxes=np.stack(boxes), scores=tr.scores))
    return out


def link_sample(classname: str, forecast_mode: str, times, per_t
                ) -> List[Trajectory]:
    """Dispatch on forecast_mode (ref forecast_boxes(), :416-470)."""
    if forecast_mode in ("velocity_constant", "velocity_forward"):
        return constant_velocity_trajectories(per_t, times, reverse=False)
    if forecast_mode == "velocity_reverse":
        return constant_velocity_trajectories(per_t, times, reverse=True)
    if forecast_mode == "velocity_dense":
        return tracker(classname, times, per_t)
    if forecast_mode.startswith("velocity_sparse"):
        # Parity note: the reference's velocity_sparse_{forward,reverse,
        # match} modes are unreachable dead code — after their pre-match
        # branch (ref nuscenes.py:419-427) the final dispatch has no case
        # for them and hits `assert False, "Invalid Forecast Mode"`
        # (ref nuscenes.py:470-471). We fail loudly with the same contract.
        raise ValueError(
            f"{forecast_mode} is dead code in the reference (its final "
            f"dispatch asserts); use velocity_dense for the sparse head")
    raise ValueError(f"unknown forecast_mode {forecast_mode}")


def trajectory_score(tr: Trajectory, rerank: str, timesteps: int) -> float:
    """ref :495-508."""
    if rerank == "first":
        return float(tr.scores[0])
    if rerank == "last":
        return float(tr.scores[-1])
    if rerank == "add":
        return float(np.sum(tr.scores[:timesteps]) / timesteps)
    if rerank == "mult":
        return float(np.prod(tr.scores[:timesteps]))
    raise ValueError(rerank)


def snap_to_prototypes(trajs: List[Trajectory], prototypes) -> List[Trajectory]:
    """--postprocess: snap each predicted trajectory's future offsets to the
    nearest train-set prototype (ref process_trajectories,
    nuscenes.py:341-382; prototypes from cli.tools trajectory, ref
    trajectory.py:43-65).

    prototypes: list of [(vel2, quat4)] + (T-1) xyz offsets (the pkl layout).
    Matching key = [vel, quat, flattened offsets]; the matched prototype's
    offsets replace the prediction's future positions.
    """
    if not trajs or not prototypes:
        return trajs
    proto_vecs = []
    proto_offsets = []
    for p in prototypes:
        vel, rot = p[0]
        offs = np.concatenate([np.asarray(o, np.float64).ravel()
                               for o in p[1:]])
        proto_vecs.append(np.concatenate([np.asarray(vel, np.float64).ravel(),
                                          np.asarray(rot, np.float64).ravel(),
                                          offs]))
        proto_offsets.append(np.stack([np.asarray(o, np.float64)
                                       for o in p[1:]]))
    proto_vecs = np.stack(proto_vecs)

    out = []
    for tr in trajs:
        T = tr.boxes.shape[0]
        start = tr.boxes[0]
        yaw = -start[8] - np.pi / 2
        rot = [np.cos(yaw / 2), 0.0, 0.0, np.sin(yaw / 2)]
        offs = np.concatenate([(tr.boxes[t, :3] - start[:3])
                               for t in range(1, T)])
        key = np.concatenate([start[6:8], rot, offs])
        if proto_vecs.shape[1] != key.shape[0]:
            raise ValueError(
                f"trajectory prototypes were built for a different horizon "
                f"({proto_vecs.shape[1]}-dim keys vs {key.shape[0]}-dim "
                f"trajectories) — rebuild with `cli.tools trajectory` on "
                f"infos generated with the eval's timesteps")
        j = int(np.argmin(np.linalg.norm(proto_vecs - key, axis=1)))
        boxes = tr.boxes.copy()
        for t in range(1, min(T, len(proto_offsets[j]) + 1)):
            boxes[t, :3] = start[:3] + proto_offsets[j][t - 1]
        out.append(Trajectory(boxes=boxes, scores=tr.scores,
                              forecast_id=tr.forecast_id))
    return out


def jitter_trajectories(trajs: List[Trajectory], times, K: int, C: float,
                        rng=None) -> List[Trajectory]:
    """K-1 extra constant-velocity futures per trajectory with velocity noise
    scaled by C * |v| (ref nuscenes.py:473-491, --jitter/--K/--C flags)."""
    rng = rng or np.random.default_rng(0)
    out = list(trajs)
    T = len(times) + 1
    for tr in trajs:
        start = tr.boxes[0]
        vnorm = C * float(np.linalg.norm(start[6:8]))
        for _ in range(K - 1):
            jv = rng.normal(start[6:8], vnorm)
            boxes = [start.copy()]
            for i in range(T - 1):
                nb = boxes[-1].copy()
                nb[:2] = nb[:2] + times[i] * jv
                boxes.append(nb)
            out.append(Trajectory(boxes=np.stack(boxes), scores=tr.scores,
                                  forecast_id=tr.forecast_id))
    return out


class _UnionFind:
    def __init__(self, n):
        self.p = list(range(n))

    def find(self, x):
        while self.p[x] != x:
            self.p[x] = self.p[self.p[x]]
            x = self.p[x]
        return x

    def union(self, a, b):
        ra, rb = self.find(a), self.find(b)
        if ra != rb:
            self.p[rb] = ra


def multi_future(trajs: List[Trajectory]) -> List[Trajectory]:
    """Assign forecast_id by grouping trajectories whose t=0 centers are
    within MATCH_THRESH (connected components, ref :299-339 — union-find in
    place of networkx)."""
    if not trajs:
        return trajs
    centers = np.stack([t.boxes[0][:2] for t in trajs])
    d = _dist_matrix(centers, centers)
    uf = _UnionFind(len(trajs))
    ia, ib = np.where(d < MATCH_THRESH)
    for a, b in zip(ia, ib):
        uf.union(int(a), int(b))
    roots = {}
    for i, t in enumerate(trajs):
        r = uf.find(i)
        gid = roots.setdefault(r, len(roots))
        t.forecast_id = gid
    return trajs
