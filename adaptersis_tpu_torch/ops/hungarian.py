"""Exact linear-sum assignment on the device: batched Jonker–Volgenant
(LAPJV), the counterpart of the JAX package's `ops/hungarian.py`.

Mask2Former's matcher solves one assignment per image and decoder layer:
a (Q, G) cost of Q queries against G ≤ Q ground-truth segments. The
solver keeps the JAX form: for each ground-truth row r, a Dijkstra scan
over the Q queries on reduced costs (each scan labels one column for
good, and only columns already assigned extend the path, so r + 1 scans
always reach a free one), then the augmentation back along the
predecessors and the dual update. Every loop has the static bound G, and
every branch (`lax.cond` in the JAX code) is a `torch.where` over the
batch, so a solve is a fixed sequence of small tensor ops on whatever
device the cost lies on: no `.item()`, no host synchronisation. The batch
axis carries every image of every decoder layer at once.

The total cost equals scipy's `linear_sum_assignment` for any finite cost
matrix; on exact ties the assignment may differ. The JAX package's
`ASN_M2F_*_HUNGARIAN` switches choose between its device solver and a host
callback on the TPU; the port has one solver and no switch. K > Q (more
segments than queries) raises: the JAX package needs its host path there.
"""

from __future__ import annotations

import torch


def _lapjv(cost_t: torch.Tensor) -> torch.Tensor:
    """cost_t (N, G, Q), G ≤ Q. Returns y (N, G) int64: the query assigned
    to each ground-truth row, minimising the total cost."""
    N, G, Q = cost_t.shape
    dev = cost_t.device
    # row reduction (assignment-invariant): the loss pads missing segments
    # with constant 1e6 rows, which become all-zero rows here, keeping every
    # dual and distance at the scale of the real costs
    cost_t = cost_t - cost_t.min(dim=2, keepdim=True).values
    inf = torch.full((), float("inf"), dtype=cost_t.dtype, device=dev)   # a fill, no copy
    rows = torch.arange(N, device=dev)
    cols = torch.arange(Q, device=dev)[None]
    gts = torch.arange(G, device=dev)[None]
    # v must start at zero (pure shortest augmenting paths), see the JAX
    # module: a column-reduction start without its greedy pre-assignment
    # breaks the invariants
    v = cost_t.new_zeros((N, Q))                                # column duals
    x = torch.full((N, Q), -1, dtype=torch.long, device=dev)    # query → row
    y = torch.full((N, G), -1, dtype=torch.long, device=dev)    # row → query
    for r in range(G):
        dist = cost_t[:, r] - v
        pred = torch.full((N, Q), r, dtype=torch.long, device=dev)
        visited = torch.zeros((N, Q), dtype=torch.bool, device=dev)
        jfree = torch.full((N,), -1, dtype=torch.long, device=dev)
        delta = cost_t.new_zeros(N)
        for _ in range(r + 1):
            active = jfree < 0
            masked = torch.where(visited, inf, dist)
            j = masked.argmin(dim=1)
            dj = masked[rows, j]
            visited = visited | ((cols == j[:, None]) & active[:, None])
            i = x[rows, j]
            hit = active & (i < 0)
            jfree = torch.where(hit, j, jfree)
            delta = torch.where(hit, dj, delta)
            relax = active & (i >= 0)
            ic = i.clamp(min=0)
            yi = y[rows, ic].clamp(min=0)
            ci = cost_t[rows, ic]                               # (N, Q)
            # u_i from complementary slackness on (i, y[i]); (ci − v) first:
            # for padded rows both are of one scale (see the JAX module)
            u_i = ci[rows, yi] - v[rows, yi]
            nd = (ci - v) + (dj - u_i)[:, None]
            upd = relax[:, None] & ~visited & (nd < dist)
            dist = torch.where(upd, nd, dist)
            pred = torch.where(upd, ic[:, None], pred)
        # dual update on the scanned set (the free column's dist is delta)
        v = torch.where(visited, v + dist - delta[:, None], v)
        # augment: walk the predecessors back to row r
        j, active = jfree, torch.ones(N, dtype=torch.bool, device=dev)
        for _ in range(r + 1):
            i = pred[rows, j]
            jn = y[rows, i]
            y = torch.where(active[:, None] & (gts == i[:, None]), j[:, None], y)
            x = torch.where(active[:, None] & (cols == j[:, None]), i[:, None], x)
            active = active & (i != r)
            j = torch.where(active, jn, j)
    return y


def lapjv(cost: torch.Tensor) -> torch.Tensor:
    """(B, Q, G) cost, G ≤ Q → (B, 2, G) int64 [query index, gt index]
    pairs, in gt-slot order (scipy's `linear_sum_assignment` contract as
    `hungarian_match` promises it). Solved in the cost's float type (fp32
    at least)."""
    B, Q, G = cost.shape
    if G > Q:
        raise ValueError(f"lapjv: need G <= Q, got Q={Q}, G={G} (more segments than queries)")
    ct = torch.promote_types(cost.dtype, torch.float32)
    y = _lapjv(cost.detach().to(ct).transpose(1, 2))
    g = torch.arange(G, device=cost.device).expand(B, G)
    return torch.stack([y, g], dim=1)
