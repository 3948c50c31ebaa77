"""Host-side town road network and global route planning (port of
carla_ppo_tpu/envs/route_planner.py).

A procedurally generated jittered-grid town: routes are A* shortest paths
over its road graph under Euclidean edge weights, their interior corners
rounded by arc fillets, resampled at 1 m and tagged with the junction
maneuvers (|turn| < 35 deg STRAIGHT, else LEFT / RIGHT by the cross
product) and, on dual-lane edges that end in a left turn, a lane change.
`make_route_bank` stacks a pool of such routes into one TrackData bank.

Everything runs once at startup in numpy; only the finished bank becomes
tensors on the caller's device. The JAX package builds its graph with
networkx (connectivity check, A* fallback) and runs A* natively; this
module needs neither. Its graph keeps networkx's iteration order (nodes in
insertion order, each node's neighbours in insertion order, each undirected
edge listed once, from the node seen first), so the same seed gives the
same town and the same edge list, and its A* is the native one's:
a binary heap on (f, node) over the same weights and heuristic.
"""

from __future__ import annotations

import dataclasses
import heapq
import math
from typing import Dict, List, Sequence, Tuple

import numpy as np

from carla_ppo_tpu_torch.envs import track as track_mod
from carla_ppo_tpu_torch.envs.types import RoadOption, SegClass, TrackData

# Junction turn classification threshold (rad).
_STRAIGHT_THRESHOLD = math.radians(35.0)

# Lane width (m): two default half-widths.
LANE_WIDTH = 2.0 * track_mod.DEFAULT_HALF_WIDTH
# Dual-lane edges shorter than this stay single (no room for a lane change).
_MIN_DUAL_LENGTH = 60.0


@dataclasses.dataclass
class TownMap:
    """A planar road graph: node positions + undirected edges; `dual` flags
    dual-lane carriageways, aligned with `edges` (None = all single)."""

    nodes: np.ndarray  # [N, 2] float
    edges: List[Tuple[int, int]]
    dual: List[bool] | None = None

    def dual_lookup(self) -> Dict[frozenset, bool]:
        if self.dual is None:
            return {}
        return {frozenset(e): bool(d) for e, d in zip(self.edges, self.dual)}


class _Graph:
    """Undirected graph with networkx.Graph's iteration order."""

    def __init__(self, n_nodes: int):
        self.adj: Dict[int, Dict[int, None]] = {i: {} for i in range(n_nodes)}

    def add_edge(self, a: int, b: int) -> None:
        self.adj[a].setdefault(b, None)
        self.adj[b].setdefault(a, None)

    def edges(self) -> List[Tuple[int, int]]:
        seen = set()
        out = []
        for n, nbrs in self.adj.items():
            out.extend((n, m) for m in nbrs if m not in seen)
            seen.add(n)
        return out

    def is_connected(self) -> bool:
        start = next(iter(self.adj))
        seen, frontier = {start}, [start]
        while frontier:
            n = frontier.pop()
            for m in self.adj[n]:
                if m not in seen:
                    seen.add(m)
                    frontier.append(m)
        return len(seen) == len(self.adj)


def make_town(
    seed: int = 0,
    grid: Tuple[int, int] = (5, 5),
    spacing: float = 120.0,
    jitter: float = 18.0,
    drop_edge_prob: float = 0.18,
    dual_lane_prob: float = 0.3,
) -> TownMap:
    """Jittered-grid road network, guaranteed connected; ~`dual_lane_prob` of
    the roads are dual-lane carriageways."""
    rng = np.random.default_rng(seed)
    gx, gy = grid
    nodes = np.zeros((gx * gy, 2))
    for ix in range(gx):
        for iy in range(gy):
            nodes[ix * gy + iy] = (
                ix * spacing + rng.uniform(-jitter, jitter),
                iy * spacing + rng.uniform(-jitter, jitter),
            )
    all_edges = []
    for ix in range(gx):
        for iy in range(gy):
            n = ix * gy + iy
            if ix + 1 < gx:
                all_edges.append((n, (ix + 1) * gy + iy))
            if iy + 1 < gy:
                all_edges.append((n, ix * gy + iy + 1))

    keep = [e for e in all_edges if rng.uniform() > drop_edge_prob]
    g = _Graph(len(nodes))
    for e in keep:
        g.add_edge(*e)
    # Re-add dropped edges until connected.
    kept = set(keep)
    dropped = [e for e in all_edges if e not in kept]
    rng.shuffle(dropped)
    for e in dropped:
        if g.is_connected():
            break
        g.add_edge(*e)
    edges = g.edges()
    dual = [bool(rng.uniform() < dual_lane_prob) for _ in edges]
    return TownMap(nodes=nodes, edges=edges, dual=dual)


def route_astar(nodes: np.ndarray, edges: Sequence[Tuple[int, int]], start: int, goal: int) -> List[int]:
    """Shortest node path under Euclidean edge weights (A*, Euclidean
    heuristic; a heap of (f, node), stale entries skipped); raises
    ValueError if `goal` is unreachable."""
    n_nodes = len(nodes)
    if not (0 <= start < n_nodes and 0 <= goal < n_nodes):
        raise ValueError(f"route_astar: node out of range {start} -> {goal}")
    xy = [(float(x), float(y)) for x, y in nodes]

    def dist(a: int, b: int) -> float:
        dx = xy[a][0] - xy[b][0]
        dy = xy[a][1] - xy[b][1]
        return math.sqrt(dx * dx + dy * dy)

    adj: List[List[Tuple[int, float]]] = [[] for _ in range(n_nodes)]
    for a, b in edges:
        w = dist(a, b)
        adj[a].append((b, w))
        adj[b].append((a, w))

    inf = 1e30
    g = [inf] * n_nodes
    parent = [-1] * n_nodes
    g[start] = 0.0
    heap = [(dist(start, goal), start)]
    while heap:
        f, n = heapq.heappop(heap)
        if n == goal:
            break
        if f > g[n] + dist(n, goal) + 1e-9:
            continue  # stale entry
        for m, w in adj[n]:
            cand = g[n] + w
            if cand < g[m]:
                g[m] = cand
                parent[m] = n
                heapq.heappush(heap, (cand + dist(m, goal), m))
    if g[goal] >= inf:
        raise ValueError(f"route_astar: no path {start} -> {goal}")
    path = [goal]
    while parent[path[-1]] != -1:
        path.append(parent[path[-1]])
    return path[::-1]


def _fillet_path(points: np.ndarray, radius: float = 14.0, samples_per_arc: int = 24) -> np.ndarray:
    """Round interior corners of a polyline with circular arc fillets."""
    if len(points) <= 2:
        return points.astype(np.float64)
    out = [points[0]]
    for i in range(1, len(points) - 1):
        p_prev, p, p_next = points[i - 1], points[i], points[i + 1]
        v_in = p - p_prev
        v_out = p_next - p
        l_in, l_out = np.linalg.norm(v_in), np.linalg.norm(v_out)
        u_in, u_out = v_in / l_in, v_out / l_out
        turn = math.atan2(u_in[0] * u_out[1] - u_in[1] * u_out[0], np.dot(u_in, u_out))
        if abs(turn) < 1e-3:
            out.append(p)
            continue
        # Fillet tangent length; clamped so short edges still work.
        t = min(radius * abs(math.tan(turn / 2.0)), 0.4 * l_in, 0.4 * l_out)
        r_eff = t / abs(math.tan(turn / 2.0))
        start = p - u_in * t
        out.append(start)
        heading = math.atan2(u_in[1], u_in[0])
        sign = 1.0 if turn > 0 else -1.0
        center = start + r_eff * np.array(
            [math.cos(heading + sign * math.pi / 2), math.sin(heading + sign * math.pi / 2)]
        )
        a0 = math.atan2(start[1] - center[1], start[0] - center[0])
        for k in range(1, samples_per_arc + 1):
            a = a0 + turn * k / samples_per_arc
            out.append(center + r_eff * np.array([math.cos(a), math.sin(a)]))
    out.append(points[-1])
    return np.asarray(out)


def _junction_maneuvers(node_path: Sequence[int], nodes: np.ndarray) -> List[Tuple[np.ndarray, int]]:
    """(junction position, RoadOption) per interior node of the path."""
    out = []
    for i in range(1, len(node_path) - 1):
        p_prev = nodes[node_path[i - 1]]
        p = nodes[node_path[i]]
        p_next = nodes[node_path[i + 1]]
        u_in = p - p_prev
        u_out = p_next - p
        turn = math.atan2(u_in[0] * u_out[1] - u_in[1] * u_out[0], float(np.dot(u_in, u_out)))
        if abs(turn) < _STRAIGHT_THRESHOLD:
            opt = RoadOption.STRAIGHT
        elif turn > 0:
            opt = RoadOption.LEFT
        else:
            opt = RoadOption.RIGHT
        out.append((p, int(opt)))
    return out


def compute_route_waypoints(
    town: TownMap, start_node: int, end_node: int, resolution: float = 1.0
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """A* route -> (pos [n,2] f32, fwd [n,2] f32, maneuver [n] i32,
    left_width [n] f32, right_width [n] f32) at 1 m resolution.

    LANEFOLLOW between junctions; each junction's turn painted over the
    waypoints within 15 m of it. On a dual-lane edge the route drives the
    right lane and, when the junction at the edge's far end turns LEFT,
    shifts to the left lane mid-edge (CHANGELANELEFT); the other lane
    widens the road on its side (asymmetric per-waypoint widths)."""
    node_path = route_astar(town.nodes, town.edges, int(start_node), int(end_node))
    dual = town.dual_lookup()
    junctions = _junction_maneuvers(node_path, town.nodes)
    turn_at = {i + 1: opt for i, (_, opt) in enumerate(junctions)}

    # Macro polyline with lane offsets on dual edges.
    pts: List[np.ndarray] = [town.nodes[node_path[0]]]
    lane_changes: List[Tuple[np.ndarray, int, float]] = []  # (mid, opt, span)
    dual_edges: List[Tuple[np.ndarray, np.ndarray]] = []
    for i in range(len(node_path) - 1):
        a = town.nodes[node_path[i]].astype(np.float64)
        b = town.nodes[node_path[i + 1]].astype(np.float64)
        L = float(np.linalg.norm(b - a))
        u = (b - a) / L
        nr = np.array([u[1], -u[0]])  # right normal of the travel direction
        is_dual = dual.get(frozenset((node_path[i], node_path[i + 1])), False)
        if is_dual and L >= _MIN_DUAL_LENGTH:
            off_r = nr * (LANE_WIDTH / 2.0)
            turn_in = turn_at.get(i, int(RoadOption.STRAIGHT))
            turn_out = turn_at.get(i + 1, int(RoadOption.STRAIGHT))
            change = turn_out == int(RoadOption.LEFT)  # exit left before a left turn
            exit_off = -off_r if change else off_r
            # Lane-offset points stay clear of turning junctions, so the
            # corner fillets keep their full radius.
            enter_frac = 0.40 if turn_in != int(RoadOption.STRAIGHT) else 0.15
            exit_frac = 0.60 if turn_out != int(RoadOption.STRAIGHT) else 0.85
            pts.append(a + u * (enter_frac * L) + off_r)
            if change:
                if enter_frac < 0.45:
                    pts.append(a + u * (0.45 * L) + off_r)
                pts.append(a + u * (0.60 * L) + exit_off)
                lane_changes.append((a + u * (0.525 * L), int(RoadOption.CHANGELANELEFT), 0.15 * L))
            elif exit_frac > enter_frac:
                pts.append(a + u * (exit_frac * L) + exit_off)
            dual_edges.append((a, b))
        pts.append(b)
    smooth = _fillet_path(np.asarray(pts))

    pos = track_mod._resample_polyline(smooth, resolution, closed=False)
    fwd = track_mod._forward_vectors(pos, closed=False)

    maneuver = np.full(pos.shape[0], int(RoadOption.LANEFOLLOW), np.int32)
    for junction_pos, opt in junctions:
        d = np.linalg.norm(pos - junction_pos[None, :], axis=1)
        maneuver[d < 15.0] = opt
    for mid, opt, span in lane_changes:
        d = np.linalg.norm(pos - mid[None, :], axis=1)
        maneuver[d < span / 2.0 + 4.0] = opt

    # Symmetric single lane by default; on dual edges the other lane
    # extends the road continuously on its side.
    half = track_mod.DEFAULT_HALF_WIDTH
    lw = np.full(pos.shape[0], half, np.float32)
    rw = np.full(pos.shape[0], half, np.float32)
    for a, b in dual_edges:
        L = float(np.linalg.norm(b - a))
        u = (b - a) / L
        nr = np.array([u[1], -u[0]])
        rel = pos - a[None, :]
        along = rel @ u
        r = rel @ nr  # + = right of the edge axis
        ar = np.abs(r)
        onseg = (along > -2.0) & (along < L + 2.0) & (ar < 2.5 * LANE_WIDTH)
        # Trapezoid in |r|: full width at the lane center, faded out by 2.5
        # lanes off-axis, tapered within ~6 m of the edge ends.
        frac = np.clip(
            np.minimum(ar / (LANE_WIDTH / 2.0), (2.5 * LANE_WIDTH - ar) / (1.5 * LANE_WIDTH)),
            0.0, 1.0,
        )
        taper = np.clip((along + 2.0) / 6.0, 0.0, 1.0) * np.clip((L + 2.0 - along) / 6.0, 0.0, 1.0)
        extra = (LANE_WIDTH * frac * taper).astype(np.float32)
        right_lane = onseg & (r > 0)
        left_lane = onseg & (r < 0)
        lw[right_lane] = np.maximum(lw[right_lane], half + extra[right_lane])
        rw[left_lane] = np.maximum(rw[left_lane], half + extra[left_lane])
    return pos.astype(np.float32), fwd.astype(np.float32), maneuver, lw, rw


def make_route_bank(
    town: TownMap,
    n_routes: int = 64,
    capacity: int = 1024,
    min_length: float = 150.0,
    seed: int = 0,
    half_width: float = track_mod.DEFAULT_HALF_WIDTH,
    props: bool = False,
    device="cuda",
) -> TrackData:
    """A bank of `n_routes` random routes (random node pairs, at least
    `min_length` waypoints, cut to `capacity` and padded with the last
    waypoint) as one TrackData on `device`: leading route axis, `length`
    [R] int32, open (`is_loop` False). With `props`, route i is dressed
    with props seeded `seed * 1009 + i`. `half_width` is the JAX
    signature's: every slot takes its route's own widths, in both
    packages, so it changes nothing."""
    del half_width
    rng = np.random.default_rng(seed)
    n_nodes = len(town.nodes)
    n_slots = capacity // track_mod.PROP_STRIDE
    routes: List[dict] = []
    attempts = 0
    while len(routes) < n_routes:
        attempts += 1
        if attempts > n_routes * 50:
            raise RuntimeError("could not sample enough valid routes")
        a, b = rng.choice(n_nodes, size=2, replace=False)
        try:
            pos, fwd, man, lw, rw = compute_route_waypoints(town, int(a), int(b))
        except ValueError:  # no path between the two nodes
            continue
        n = min(len(pos), capacity)
        if n < min_length:
            continue

        def padded(x):  # the last waypoint repeated keeps gathers on the road
            out = np.empty((capacity,) + x.shape[1:], x.dtype)
            out[:n] = x[:n]
            out[n:] = x[n - 1]
            return out

        routes.append({
            "pos": padded(pos), "fwd": padded(fwd), "maneuver": padded(man),
            "left_width": padded(lw), "right_width": padded(rw),
            "length": n, "is_loop": False,
            "prop_class": np.full((n_slots, 2), int(SegClass.NONE), np.int32),
            "prop_lateral": np.zeros((n_slots, 2), np.float32),
            "prop_height": np.zeros((n_slots, 2), np.float32),
            "prop_halfwidth": np.zeros((n_slots, 2), np.float32),
        })
    if props:
        routes = [track_mod._bake_props_arrays(r, seed=seed * 1009 + i) for i, r in enumerate(routes)]
    return track_mod.bank_from_arrays(routes, device)
