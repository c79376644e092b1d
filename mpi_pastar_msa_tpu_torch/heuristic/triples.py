"""Triple-wise heuristic: exact weighted 3-sequence suffix DP per triangle.

Strengthens the pairwise HPair bound (ref: pastar/HeuristicHPair.cpp:73-86)
by replacing, for a cover of triangles (x, y, z), the three independent
pairwise terms

    w_xy*t_xy[cx,cy] + w_xz*t_xz[cx,cz] + w_yz*t_yz[cy,cz]

with the jointly-optimal value

    H3[cx,cy,cz] = min over 3-seq suffix alignments of the weighted sum of
                   the SAME per-column pair costs (ref: pastar/Node.cpp:129-152)

Valid when GapOpen == GapExtension (the reference default,
pastar/include/Cost.h:13), which makes every edge cost column-local: the
bound is admissible (projecting any remaining N-path onto (x, y, z) costs at
least the 3-seq minimum), consistent (one move with a non-empty (x, y, z)
sub-mask is one DP transition) and dominates the pairwise sum.

The cube fill (kernel K2) walks anti-diagonal planes d = i+j+k from
Lx+Ly+Lz down to 0: plane d depends only on planes d+1..d+3.  On a CUDA
tensor ``triple_tables`` launches the hand-written kernel
``csrc/triple_wavefront.cu`` (tiles of 32 x 16 x 16 cells, one launch per
tile diagonal, one block per tile; its shape from ``k2_launch_shape``); on
a CPU tensor it runs the plain PyTorch version below, a loop over planes
batched over all T cubes.  The CUDA path never falls back to the plain
version.  Port of the JAX package's ``heuristic/triples.py``; the covers,
the host oracle and the cube layout are the same, so the same inputs give
the same cubes bit for bit.
"""
from __future__ import annotations

import warnings
from dataclasses import dataclass, field
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .. import _kernels
from ..core.cost import COST_TABLE, GAP_EXTENSION, GAP_GAP, GAP_OPEN
from ..core.problem import Problem
from ..utils.device import resolve_device
from .hpair import HPairHeuristic
from .wavefront import _check

INF3 = 2**30
#: the tile (bi, bj, bk) K2 is compiled for (``kBi, kBj, kBk`` in
#: ``csrc/triple_wavefront.cu``; its C entry refuses any other), k fastest
#: as in the stack
K2_TILE = (32, 16, 16)


class K2Shape(NamedTuple):
    """The launch shape of one K2 fill (see ``k2_launch_shape``)."""
    tile: Tuple[int, int, int]  # (bi, bj, bk)
    tiles: np.ndarray  # (T, 3) tiles a side of each cube's box
    diagonals: int  # tile diagonals, one launch each
    grid: np.ndarray  # (diagonals, 4) int32: a_lo, b_lo, tile rows, tile columns
    blocks: int  # blocks over all those launches
    max_blocks: int  # blocks of the largest launch
    threads: int  # threads per block, one per (j, k) column of a tile


def k2_launch_shape(lens, S: int, tile=K2_TILE) -> K2Shape:
    """The launch shape of K2 for cube lengths ``lens`` (T, 3) at stride S.

    Each cube's (Lx+1, Ly+1, Lz+1) box is cut into tiles of ``tile`` cells;
    the fill launches once per tile diagonal D = a+b+c, over the rectangle
    of tile rows a and columns b that can hold a tile of D in a cube of the
    largest tile counts of the T cubes, one block of bj * bk threads per
    (a, b, cube).  ``grid[D]`` is that rectangle as the kernel takes it.  The
    kernel is compiled for ``K2_TILE``; other tiles serve the CPU emulation
    of its schedule."""
    bi, bj, bk = (int(v) for v in tile)
    L = np.asarray(lens, dtype=np.int64).reshape(-1, 3)
    if len(L) < 1 or L.min() < 0 or L.max() > S - 2 or min(bi, bj, bk) < 1:
        raise ValueError(f"K2: need T >= 1, lengths in [0, S-2] (S = {S}) and "
                         f"tile sides >= 1, got {L.tolist()} and {tile}")
    tiles = -(-(L + 1) // np.array([bi, bj, bk]))
    na, nb, nc = (int(v) for v in tiles.max(0))
    diagonals = int(tiles.sum(1).max()) - 2
    grid = np.zeros((diagonals, 4), dtype=np.int32)
    for D in range(diagonals):
        a_lo, a_hi = max(0, D - (nb - 1) - (nc - 1)), min(na - 1, D)
        b_lo, b_hi = max(0, D - a_hi - (nc - 1)), min(nb - 1, D - a_lo)
        grid[D] = (a_lo, b_lo, a_hi - a_lo + 1, b_hi - b_lo + 1)
    sizes = grid[:, 2].astype(np.int64) * grid[:, 3] * len(L)
    return K2Shape((bi, bj, bk), tiles, diagonals, grid, int(sizes.sum()),
                   int(sizes.max()), bj * bk)


def pick_triangles(weight_i: np.ndarray, n: int,
                   max_triangles: Optional[int] = None) -> List[Tuple[int, int, int]]:
    """Greedy max-weight edge-disjoint triangle packing over K_n.

    Each triangle's score is the sum of its three Altschul pair weights —
    the heuristic mass it gets to couple jointly.  Edge-disjointness keeps
    the summed bound admissible (every pair counted once).
    """
    cands = []
    for x in range(n):
        for y in range(x + 1, n):
            for z in range(y + 1, n):
                w = int(weight_i[x, y]) + int(weight_i[x, z]) + int(weight_i[y, z])
                cands.append((w, (x, y, z)))
    cands.sort(key=lambda t: (-t[0], t[1]))
    used = set()
    out: List[Tuple[int, int, int]] = []
    for _, (x, y, z) in cands:
        edges = {(x, y), (x, z), (y, z)}
        if edges & used:
            continue
        used |= edges
        out.append((x, y, z))
        if max_triangles is not None and len(out) >= max_triangles:
            break
    return out


def pick_cover(weight_i: np.ndarray, n: int,
               max_triangles: Optional[int] = None
               ) -> List[Tuple[Tuple[int, int, int], Tuple[int, int, int]]]:
    """Weighted triangle cover: every pair's FULL weight lives in exactly one
    cube (or stays pairwise), so the summed bound remains admissible.

    Phase 1: greedy max-weight edge-disjoint triangle packing (full weights).
    Phase 2: leftover pairs are coupled two-at-a-time by "cherry" triangles —
    two leftover edges sharing a vertex form triangle (a, b, c) whose third
    edge gets weight 0.  A zero-weight pair contributes nothing to the cube's
    objective but the cube still enforces joint sequence consistency on the
    two live pairs, so the cube value >= the two pairwise table values.

    Returns [(triangle, (w_xy, w_xz, w_yz)), ...] with x < y < z per triangle.
    """
    tris = pick_triangles(weight_i, n, max_triangles=max_triangles)
    out = []
    used = set()
    for (x, y, z) in tris:
        out.append(((x, y, z), (int(weight_i[x, y]), int(weight_i[x, z]),
                                int(weight_i[y, z]))))
        used |= {(x, y), (x, z), (y, z)}
    if max_triangles is not None and len(out) >= max_triangles:
        return out[:max_triangles]
    # leftover pairs, greedily matched into vertex-sharing cherries
    left = [(x, y) for x in range(n) for y in range(x + 1, n)
            if (x, y) not in used]
    cherries = []
    for i, e1 in enumerate(left):
        for j in range(i + 1, len(left)):
            e2 = left[j]
            shared = set(e1) & set(e2)
            if len(shared) == 1:
                w = (int(weight_i[e1[0], e1[1]]) + int(weight_i[e2[0], e2[1]]))
                cherries.append((w, e1, e2))
    cherries.sort(key=lambda t: (-t[0], t[1], t[2]))
    taken = set()
    for _, e1, e2 in cherries:
        if max_triangles is not None and len(out) >= max_triangles:
            break
        if e1 in taken or e2 in taken:
            continue
        taken |= {e1, e2}
        x, y, z = sorted(set(e1) | set(e2))
        live = {e1, e2}
        ws = tuple(int(weight_i[a, b]) if (a, b) in live else 0
                   for (a, b) in ((x, y), (x, z), (y, z)))
        out.append(((x, y, z), ws))
    return out


def pick_fractional_cover(weight_i: np.ndarray, n: int
                          ) -> List[Tuple[Tuple[int, int, int], Tuple[int, int, int]]]:
    """All-triples fractional cover: EVERY triangle of K_n gets each of its
    pairs at the pair's full weight, and all edge costs (and hence g) are
    scaled by ``n - 2``.

    Each pair (a, b) lies in exactly n-2 triangles, so the per-cube shares
    sum to (n-2)*w_ab — the classic "sum over all triples divided by (n-2)"
    MSA lower bound, realized with integer arithmetic by scaling the whole
    cost algebra instead of dividing the bound.  Admissible for the scaled
    search: projecting any remaining N-path onto each triangle costs at
    least that cube's DP minimum, and summing over all cubes counts every
    pair exactly n-2 times.  Consistent by the same per-move argument as the
    cherry cover (module docstring).  Dominates (n-2) x the pairwise bound
    cube-by-cube, and couples every pair with ALL of its third partners
    rather than the single partner the cherry cover picks.
    """
    out = []
    for x in range(n):
        for y in range(x + 1, n):
            for z in range(y + 1, n):
                out.append(((x, y, z),
                            (int(weight_i[x, y]), int(weight_i[x, z]),
                             int(weight_i[y, z]))))
    return out


def triple_suffix_table_host(sx: str, sy: str, sz: str,
                             wxy: int, wxz: int, wyz: int) -> np.ndarray:
    """Reference-style host oracle: (Lx+1, Ly+1, Lz+1) int64 suffix DP.

    Plain loops — used only by tests (tiny L) to validate the device
    wavefront bit-for-bit.  Requires GapOpen == GapExtension.
    """
    if GAP_OPEN != GAP_EXTENSION:
        raise NotImplementedError("triple DP needs GapOpen == GapExtension")
    ex = np.frombuffer(sx.encode("latin-1"), dtype=np.uint8)
    ey = np.frombuffer(sy.encode("latin-1"), dtype=np.uint8)
    ez = np.frombuffer(sz.encode("latin-1"), dtype=np.uint8)
    Lx, Ly, Lz = len(ex), len(ey), len(ez)
    big = np.int64(INF3)
    H = np.full((Lx + 1, Ly + 1, Lz + 1), big, dtype=np.int64)
    H[Lx, Ly, Lz] = 0
    E, GG = GAP_EXTENSION, GAP_GAP
    for i in range(Lx, -1, -1):
        for j in range(Ly, -1, -1):
            for k in range(Lz, -1, -1):
                if (i, j, k) == (Lx, Ly, Lz):
                    continue
                best = big
                for m in range(1, 8):
                    bx, by, bz = m & 1, (m >> 1) & 1, (m >> 2) & 1
                    if i + bx > Lx or j + by > Ly or k + bz > Lz:
                        continue
                    cxy = int(COST_TABLE[ex[i], ey[j]]) if (bx and by) else (GG if not (bx or by) else E)
                    cxz = int(COST_TABLE[ex[i], ez[k]]) if (bx and bz) else (GG if not (bx or bz) else E)
                    cyz = int(COST_TABLE[ey[j], ez[k]]) if (by and bz) else (GG if not (by or bz) else E)
                    v = H[i + bx, j + by, k + bz] + wxy * cxy + wxz * cxz + wyz * cyz
                    if v < best:
                        best = v
                H[i, j, k] = best
    return H


def triple_inputs(problem: Problem, triangles: Sequence[Tuple[int, int, int]],
                  tri_weights: Sequence[Tuple[int, int, int]], device) -> dict:
    """The K2 inputs of a cover, on ``device``: per-triangle residue-cost
    matrices cxy, cxz, cyz, each (T, S, S) int32 at stride S = Lmax + 2 (rows
    and columns past a sequence's end cost 0: only masked-out moves read
    them), lengths ``lens`` (T, 3) int32 and cube pair weights ``ws`` (T, 3)
    int32."""
    S = problem.max_length + 2
    enc = [np.frombuffer(s.encode("latin-1"), dtype=np.uint8) for s in problem.seqs]
    T = len(triangles)
    cm = np.zeros((3, T, S, S), dtype=np.int32)
    lens = np.zeros((T, 3), dtype=np.int32)
    for t, (x, y, z) in enumerate(triangles):
        ex, ey, ez = enc[x], enc[y], enc[z]
        lens[t] = (len(ex), len(ey), len(ez))
        cm[0, t, : len(ex), : len(ey)] = COST_TABLE[np.ix_(ex, ey)]
        cm[1, t, : len(ex), : len(ez)] = COST_TABLE[np.ix_(ex, ez)]
        cm[2, t, : len(ey), : len(ez)] = COST_TABLE[np.ix_(ey, ez)]
    ws = np.asarray(tri_weights, dtype=np.int32).reshape(T, 3)
    dev = torch.device(device)
    return dict(cxy=torch.from_numpy(cm[0]).to(dev),
                cxz=torch.from_numpy(cm[1]).to(dev),
                cyz=torch.from_numpy(cm[2]).to(dev),
                lens=torch.from_numpy(lens).to(dev),
                ws=torch.from_numpy(ws).to(dev))


def triple_tables_plain(cxy, cxz, cyz, lens, ws):
    """Plain PyTorch version: ((T, S, S, S) int32 cube stack with INF3 outside
    each (Lx+1, Ly+1, Lz+1) box, (T,) int32 origin values) on cxy's device.

    Written from the JAX scan (``_fill_chunk_device``): planes d+1..d+3 kept
    as (T, S, S) tensors indexed by (j, k) with i = d - j - k, one step per
    plane over all cubes, each finished plane scattered into the stack."""
    dev = cxy.device
    T, S = cxy.shape[0], cxy.shape[-1]
    E, GG = GAP_EXTENSION, GAP_GAP
    jj = torch.arange(S, device=dev)[None, :, None]  # (1, S, 1)
    kk = torch.arange(S, device=dev)[None, None, :]  # (1, 1, S)
    L = lens.long()
    Lx, Ly, Lz = (L[:, a, None, None] for a in range(3))
    wxy, wxz, wyz = (ws.long()[:, a, None, None] for a in range(3))
    flat_xy = cxy.long().reshape(T, S * S)
    flat_xz = cxz.long().reshape(T, S * S)
    gyz = cyz.long()  # cost(y[j], z[k]) is already (j, k)-indexed
    H = torch.full((T, S, S, S), INF3, dtype=torch.int32, device=dev)
    inf = torch.full((T, S, S), INF3, dtype=torch.int64, device=dev)
    p1, p2, p3 = inf, inf, inf  # planes d+1, d+2, d+3
    for d in range(int(L.sum(1).max()), -1, -1):
        ii = d - jj - kk  # (1, S, S)
        in_range = (ii >= 0) & (ii <= Lx) & (jj <= Ly) & (kk <= Lz)  # (T, S, S)
        ic = ii.clamp(0, S - 1)
        gxy = flat_xy[:, (ic * S + jj).reshape(-1)].reshape(T, S, S)
        gxz = flat_xz[:, (ic * S + kk).reshape(-1)].reshape(T, S, S)
        padded = [F.pad(p, (0, 1, 0, 1), value=INF3) for p in (p1, p2, p3)]
        best = inf
        for m in range(1, 8):
            bx, by, bz = m & 1, (m >> 1) & 1, (m >> 2) & 1
            child = padded[bx + by + bz - 1][:, by:by + S, bz:bz + S]
            ok = ((ii + bx <= Lx) & (jj + by <= Ly) & (kk + bz <= Lz)
                  & (child < INF3))
            mc = (wxy * (gxy if (bx and by) else (GG if not (bx or by) else E))
                  + wxz * (gxz if (bx and bz) else (GG if not (bx or bz) else E))
                  + wyz * (gyz if (by and bz) else (GG if not (by or bz) else E)))
            best = torch.minimum(best, torch.where(ok, child + mc, INF3))
        at_goal = (ii == Lx) & (jj == Ly) & (kk == Lz)
        newp = torch.where(in_range, torch.where(at_goal, 0, best), INF3)
        t, j, k = torch.nonzero(in_range, as_tuple=True)
        H[t, d - j - k, j, k] = newp[t, j, k].to(torch.int32)
        p1, p2, p3 = newp, p1, p2
    return H, H[:, 0, 0, 0]


def triple_tables(cxy, cxz, cyz, lens, ws):
    """(T, S, S, S) int32 cube stack and its (T,) origin values on cxy's
    device (see ``triple_tables_plain``).

    CUDA tensors launch the K2 kernel (or raise; it takes gap open equal to
    extension, as ``core/cost.py`` sets them); CPU tensors run the plain
    version."""
    if cxy.device.type != "cuda":
        return triple_tables_plain(cxy, cxz, cyz, lens, ws)
    dev = cxy.device
    T, S = cxy.shape[0], cxy.shape[-1]
    for name, t in (("cxy", cxy), ("cxz", cxz), ("cyz", cyz)):
        _check(t, name, dev, 3)
        if tuple(t.shape) != (T, S, S):
            raise ValueError(f"{name}: need shape ({T}, {S}, {S}), got {tuple(t.shape)}")
    for name, t in (("lens", lens), ("ws", ws)):
        _check(t, name, dev, 2)
        if tuple(t.shape) != (T, 3):
            raise ValueError(f"{name}: need shape ({T}, 3), got {tuple(t.shape)}")
    if GAP_OPEN != GAP_EXTENSION:
        raise ValueError(f"K2 kernel: needs gap open == gap extension, got "
                         f"{GAP_OPEN} and {GAP_EXTENSION}")
    shape = k2_launch_shape(lens.cpu().numpy(), S)
    cubes = torch.empty((T, S, S, S), dtype=torch.int32, device=dev)
    _kernels.launch(
        "triple_wavefront", cubes.data_ptr(), cxy.data_ptr(), cxz.data_ptr(),
        cyz.data_ptr(), lens.data_ptr(), ws.data_ptr(), T, S, *shape.tile,
        shape.diagonals, shape.grid.ctypes.data, GAP_OPEN, GAP_EXTENSION, GAP_GAP,
        torch.cuda.current_stream(dev).cuda_stream)
    return cubes, cubes[:, 0, 0, 0]


@dataclass
class HTriples:
    """HPair heuristic augmented with triangle suffix cubes.

    Drop-in for HPairHeuristic everywhere (same duck-typed surface); the
    engine detects ``triangles`` and couples the covered pairs jointly."""
    base: HPairHeuristic
    triangles: List[Tuple[int, int, int]]
    tri_tabs: torch.Tensor = field(repr=False)  # (T, S, S, S) int32, INF3 outside
    tri_weights: List[Tuple[int, int, int]]  # per-cube pair weights
    h_origin: np.ndarray  # (T,) int64 host copy of the cube values at the origin
    # fractional all-triples cover scales the whole cost algebra by n-2
    # (see pick_fractional_cover); the engine divides reported g by this
    cost_scale: int = 1

    # --- delegated surface -------------------------------------------------
    @property
    def problem(self) -> Problem:
        return self.base.problem

    @property
    def tables(self):
        return self.base.tables

    @property
    def weight_i(self) -> np.ndarray:
        # scaled surface: under the fractional cover every consumer of the
        # pair weights (edge costs, UB beam, path-g reconstruction) must
        # work in (n-2)-scaled units so g and h stay commensurate
        return self.base.weight_i * self.cost_scale

    @property
    def weight_f(self) -> np.ndarray:
        return self.base.weight_f

    def pair_list(self):
        return self.problem.pairs()

    def stacked_tables(self) -> np.ndarray:
        return self.base.stacked_tables()

    def pair_weights_i(self) -> np.ndarray:
        return (self.base.pair_weights_i() * self.cost_scale).astype(np.int32)

    # --- triple-aware pieces ----------------------------------------------
    @property
    def covered_pairs(self) -> set:
        """Pairs whose weight lives in a cube (zero-weight cherry edges are
        NOT covered — their pairwise term must stay in the h sum)."""
        out = set()
        for (x, y, z), (wxy, wxz, wyz) in zip(self.triangles, self.tri_weights):
            if wxy:
                out.add((x, y))
            if wxz:
                out.add((x, z))
            if wyz:
                out.add((y, z))
        return out

    def pair_weights_h_i(self) -> np.ndarray:
        """Pair weights with triangle-covered pairs zeroed — the pairwise
        part of the enhanced h (the engine's edge costs keep full weights)."""
        cov = self.covered_pairs
        return np.array(
            [0 if (x, y) in cov else int(self.weight_i[x, y])
             for x, y in self.problem.pairs()],
            dtype=np.int32,
        )

    def calculate_h(self, coord) -> int:
        c = np.asarray(coord)
        cov = self.covered_pairs
        h = 0
        for (x, y), t in zip(self.problem.pairs(), self.base.tables):
            if (x, y) not in cov:
                h += int(t[c[x], c[y]]) * int(self.weight_i[x, y])
        # the engine asks only at the origin (host copy taken at build) and
        # at the goal (every suffix cube is 0 there by construction); other
        # coordinates read one cell per cube
        if not c.any():
            return h + int(self.h_origin.sum())
        if np.array_equal(c, self.problem.final_coord):
            return h
        for ti, (x, y, z) in enumerate(self.triangles):
            h += int(self.tri_tabs[ti, int(c[x]), int(c[y]), int(c[z])])
        return h

    @classmethod
    def from_numpy(cls, base: HPairHeuristic, triangles, tri_weights, cubes,
                   cost_scale: int = 1) -> "HTriples":
        """Cubes carried over from NumPy state, e.g. the JAX package's
        ``HTriples`` (``np.asarray(tri_tabs)``, its triangles, ``tri_weights``
        and ``cost_scale``), on top of ``HPairHeuristic.from_numpy``; the
        stack lies on the CPU."""
        tabs = torch.from_numpy(np.array(cubes, dtype=np.int32))
        return cls(base=base, triangles=[tuple(int(v) for v in t) for t in triangles],
                   tri_tabs=tabs,
                   tri_weights=[tuple(int(v) for v in w) for w in tri_weights],
                   h_origin=tabs[:, 0, 0, 0].numpy().astype(np.int64),
                   cost_scale=int(cost_scale))

    @classmethod
    def build(cls, base: HPairHeuristic,
              max_triangles: Optional[int] = None,
              budget_bytes: int = 6 << 30,
              device=None, fractional: bool = False) -> Optional["HTriples"]:
        """Wrap ``base`` with as many greedy triangles as the budget allows,
        the cubes filled on ``device`` (default: the card).

        ``fractional=True`` uses the all-triples cover with (n-2)-scaled
        costs (pick_fractional_cover) when all C(n,3) cubes fit the budget;
        otherwise it falls back to the cherry cover with a RuntimeWarning.

        Returns None when triples are not applicable (N < 3, affine gap
        split, degenerate weights, or the cube would not fit the budget).
        """
        problem = base.problem
        n = problem.n_seq
        if n < 3 or GAP_OPEN != GAP_EXTENSION:
            return None
        wi = base.weight_i
        if bool((wi[~np.eye(n, dtype=bool)] <= 0).any()):
            return None  # negative edge costs: bound algebra undefined
        S = problem.max_length + 2
        # the JAX package's per-cube footprint (cube 4 B/cell + its engine's
        # corner rows 32 B/cell): the port keeps 8 B/cell (cube + the
        # engine's zeroed copy) but the same arithmetic, so the same inputs
        # pick the same cover
        per = S * S * S * 36
        cap = max(0, budget_bytes // max(per, 1))
        if max_triangles is not None:
            cap = min(cap, max_triangles)
        if cap <= 0:
            return None
        scale = 1
        cover = None
        if fractional and n >= 4:
            frac = pick_fractional_cover(wi, n)
            if len(frac) <= cap:
                cover, scale = frac, n - 2
            else:
                # the caller explicitly asked for the fractional bound —
                # degrading to the weaker cherry cover must be audible
                warnings.warn(
                    f"fractional triple cover needs {len(frac)} cubes but "
                    f"the budget allows {cap}; falling back to the cherry "
                    f"cover (cost_scale stays 1)",
                    RuntimeWarning, stacklevel=2,
                )
        if cover is None:
            cover = pick_cover(wi, n, max_triangles=cap)
        if not cover:
            return None
        tris = [t for t, _ in cover]
        tws = [w for _, w in cover]
        dev = resolve_device("cuda" if device is None else device)
        tabs, origin = triple_tables(**triple_inputs(problem, tris, tws, dev))
        return cls(base=base, triangles=tris, tri_tabs=tabs, tri_weights=tws,
                   h_origin=origin.cpu().numpy().astype(np.int64),
                   cost_scale=scale)
