"""Graph ANN: bulk k-NN graph build (NN-descent) + batched beam search.

PyTorch counterpart of ``grape_vector_db_tpu/ops/graph.py``, with the same
algorithms and the same tie rules:

- **Build** is bulk NN-descent: start from a seeded random fixed-degree
  graph and, for ``rounds`` rounds, score each node's candidates (its
  neighbours, up to ``m`` reverse neighbours, and the first ``nn_sample``
  neighbours of each of those) and keep the top ``m``. The candidate lists
  are assembled on the host in numpy, line for line as in the reference, so
  a seed gives the same lists; the device scores them ``chunk`` nodes at a
  time through ``gather_dots`` (no ``[chunk, K, D]`` block of candidate
  rows is materialized). The tail chunk is ragged: eager PyTorch needs no
  single compiled shape, and every row comes out as in the reference's
  shifted window.
- **Search** is a batched best-first beam: a per-query pool of ``pool``
  best-so-far nodes with an expanded flag; each iteration expands the best
  ``expand`` unexpanded entries, scores their neighbour lists with
  ``gather_dots`` and merges with broadcast-compare dedup (in-pool and
  within-batch checks). ``lax.scan`` becomes a Python loop.

Every selection is ``ops/topk.top_k`` (``lax.top_k``'s rule: on equal values
the lower position first; ``-inf`` runs included) and every argsort is
stable, as ``jnp.argsort`` is: with another tie order the beam would walk
another graph. Pool padding is -1; when fewer than ``expand`` finite
unexpanded entries remain, a padding slot may be picked, and
``neighbors[-1]`` then reads the last row, as in the reference.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from grape_vector_db_tpu_torch.ops.distance import prepare_queries
from grape_vector_db_tpu_torch.ops.gather import gather_dots
from grape_vector_db_tpu_torch.ops.topk import top_k

__all__ = ["build_knn_graph", "beam_search", "join_candidates"]

NEG_INF = float("-inf")


def _dots_to_scores(q: torch.Tensor, dots: torch.Tensor, cnorms: torch.Tensor,
                    metric: str) -> torch.Tensor:
    """Similarity (higher is better) from dots [B, C] and candidate norms."""
    if metric == "cosine":
        return torch.clamp(dots / torch.clamp(cnorms, min=1e-12), max=1.0)
    if metric == "dot":
        return dots
    q_sq = torch.sum(q * q, dim=-1, keepdim=True)
    return -(q_sq - 2.0 * dots + cnorms * cnorms)


def _pairwise_scores(q: torch.Tensor, cvecs: torch.Tensor, cnorms: torch.Tensor,
                     metric: str) -> torch.Tensor:
    """q [C, D] f32 vs candidate rows cvecs [C, K, D] -> [C, K] similarity:
    the reference's form, a product over materialized rows (q rounded to the
    storage type, f32 sums). The build scores through ``gather_dots``, which
    gives the same terms without the [C, K, D] block."""
    qc = q.to(cvecs.dtype).to(torch.float32)
    dots = torch.bmm(cvecs.to(torch.float32), qc[:, :, None])[:, :, 0]
    return _dots_to_scores(q, dots, cnorms, metric)


def _dedup_by_index(idxs: torch.Tensor, vals: torch.Tensor,
                    keep_first_key: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sort rows by (index, keep_first_key), stably; repeated indices after
    the first occurrence get -inf. keep_first_key = 0 entries win ties.
    Returns the sorted (indices, values)."""
    order_key = idxs.to(torch.int64) * 2 + keep_first_key.to(torch.int64)
    order = torch.argsort(order_key, dim=1, stable=True)
    s_idx = torch.gather(idxs, 1, order)
    s_val = torch.gather(vals, 1, order)
    dup = torch.zeros_like(s_idx, dtype=torch.bool)
    dup[:, 1:] = s_idx[:, 1:] == s_idx[:, :-1]
    return s_idx, torch.where(dup, NEG_INF, s_val)


def _refine_chunk(start: int, cand_idx: torch.Tensor, vectors: torch.Tensor,
                  norms: torch.Tensor, valid: torch.Tensor, m: int,
                  metric: str) -> torch.Tensor:
    """One NN-descent step for the nodes [start, start + C): candidate lists
    cand_idx [C, K] int32 -> new neighbour lists [C, m] int32, picked by
    true similarity, excluding self, invalid rows and duplicates."""
    c = cand_idx.shape[0]
    node_ids = torch.arange(start, start + c, device=cand_idx.device, dtype=torch.int32)
    q = prepare_queries(vectors[start:start + c].to(torch.float32), metric)
    cand = cand_idx.long()
    scores = _dots_to_scores(q, gather_dots(q, vectors, cand_idx), norms[cand], metric)
    scores = torch.where(cand_idx == node_ids[:, None], NEG_INF, scores)   # no self
    scores = torch.where(valid[cand], scores, NEG_INF)
    s_idx, s_val = _dedup_by_index(cand_idx, scores, torch.zeros_like(cand_idx))
    _, pos = top_k(s_val, m)
    return torch.gather(s_idx, 1, pos).to(torch.int32)


def join_candidates(neighbors: np.ndarray, nn_sample: int) -> np.ndarray:
    """One round's candidate lists [n, 2m + 2m * nn_sample] int32 from the
    graph neighbors [n, m]: N(v), R(v) (up to m reverse neighbours, the
    first m by source after a stable sort; empty places repeat N(v)[0]),
    then the first ``nn_sample`` neighbours of each of those (the
    NN-descent join). Every id lies in [0, n)."""
    n, m = neighbors.shape
    # reverse edges, capped at m per node (sort edges by dst, keep the
    # first m per destination)
    src = np.repeat(np.arange(n, dtype=np.int32), m)
    dst = neighbors.reshape(-1)
    order = np.argsort(dst, kind="stable")
    dst_s, src_s = dst[order], src[order]
    # rank of each edge within its dst group
    first_pos = np.searchsorted(dst_s, np.arange(n))
    rank = np.arange(len(dst_s)) - first_pos[dst_s]
    keep = rank < m
    rev_arr = np.full((n, m), -1, dtype=np.int32)
    rev_arr[dst_s[keep], rank[keep]] = src_s[keep]
    # NN-descent join: candidates = N(v) + R(v) + N(N(v) + R(v)); the
    # neighbours-of-reverse-neighbours term is what makes the descent
    # converge (edges are asymmetric early on)
    rev_filled = np.where(rev_arr < 0, neighbors[:, :1], rev_arr)
    u = np.concatenate([neighbors, rev_filled], axis=1)          # [n, 2m]
    non = neighbors[u, :nn_sample].reshape(n, 2 * m * nn_sample)
    return np.concatenate([neighbors, rev_filled, non], axis=1)


def build_knn_graph(
    vectors: torch.Tensor,   # [N, D] storage dtype (device)
    norms: torch.Tensor,     # [N] f32
    valid: torch.Tensor,     # [N] bool: invalid/padding rows never become neighbours
    m: int = 16,
    rounds: int = 6,
    nn_sample: int = 4,
    chunk: int = 2048,
    metric: str = "cosine",
    seed: int = 0,
) -> np.ndarray:
    """Bulk-build an m-NN graph via NN-descent. Returns neighbours [N, m]
    int32 (numpy). Per round, each node's candidates are its current
    neighbours + up to m reverse neighbours + the first ``nn_sample``
    neighbours of each of those."""
    n = int(vectors.shape[0])
    if n <= m + 1:
        # trivial graph: everyone links everyone
        base = np.arange(n, dtype=np.int32)
        nb = np.stack([np.roll(base, -(i + 1)) for i in range(max(m, 1))], axis=1)
        return nb[:, :m]
    rng = np.random.default_rng(seed)
    neighbors = rng.integers(0, n, size=(n, m), dtype=np.int32)
    self_fix = neighbors == np.arange(n, dtype=np.int32)[:, None]
    neighbors[self_fix] = (neighbors[self_fix] + 1) % n

    for _ in range(rounds):
        cand = torch.from_numpy(join_candidates(neighbors, nn_sample)).to(vectors.device)
        new = [_refine_chunk(start, cand[start:start + chunk], vectors, norms, valid,
                             m=m, metric=metric)
               for start in range(0, n, chunk)]
        neighbors = torch.cat(new).cpu().numpy()     # one sync point per round
    return neighbors


def beam_search(
    queries: torch.Tensor,    # [B, D] f32
    vectors: torch.Tensor,    # [N, D] storage dtype
    norms: torch.Tensor,      # [N] f32
    valid: torch.Tensor,      # [N] bool
    entries: torch.Tensor,    # [E] int32 global, or [B, E] per-query entry points
    neighbors: torch.Tensor,  # [N, M] int32
    k: int,
    pool: int = 128,
    expand: int = 8,
    iters: int = 12,
    metric: str = "cosine",
    impl: str = "xla",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched best-first graph search. Returns (scores [B, k] f32, indices
    [B, k] int32); short rows are padded with (-inf, 0).

    ``entries`` may be per-query ([B, E], e.g. from a centroid probe) or
    global ([E]). ``impl`` is passed to ``gather_dots`` (every value runs the
    kernel on a CUDA tensor)."""
    b = queries.shape[0]
    m = neighbors.shape[1]
    dev = vectors.device
    q = prepare_queries(queries, metric)

    # init pool from entry points
    if entries.ndim == 1:
        entries = entries[None, :].expand(b, -1)
    entries = entries.to(torch.int32)
    e = entries.shape[1]
    ent = entries.long()
    escores = _dots_to_scores(q, gather_dots(q, vectors, entries, impl=impl),
                              norms[ent], metric)
    escores = torch.where(valid[ent], escores, NEG_INF)

    pp = min(pool, max(e, k))
    expand = min(expand, pp)
    # Padding slots use -1: index 0 is a real node, and the in-pool compare
    # below would otherwise suppress it forever.
    pool_val = torch.full((b, pp), NEG_INF, device=dev)
    pool_idx = torch.full((b, pp), -1, dtype=torch.int32, device=dev)
    take = min(e, pp)
    tv, tp = top_k(escores, take)
    pool_val[:, :take] = tv
    pool_idx[:, :take] = torch.gather(entries, 1, tp)
    expanded = torch.zeros((b, pp), dtype=torch.bool, device=dev)
    expanded[:, take:] = True          # padding slots start expanded

    c = expand * m
    earlier = torch.tril(torch.ones((c, c), dtype=torch.bool, device=dev), diagonal=-1)
    for _ in range(iters):
        sel_scores = torch.where(expanded, NEG_INF, pool_val)
        _, sel_pos = top_k(sel_scores, expand)                      # [B, expand]
        sel_idx = torch.gather(pool_idx, 1, sel_pos)
        expanded = expanded.scatter(1, sel_pos, True)

        # a padding slot (-1) reads the last row's list, as in the reference
        nbrs = neighbors[sel_idx.long()].reshape(b, c)              # [B, expand*M]
        nl = nbrs.long()
        cscores = _dots_to_scores(q, gather_dots(q, vectors, nbrs, impl=impl),
                                  norms[nl], metric)
        cscores = torch.where(valid[nl], cscores, NEG_INF)
        # A candidate dies if it is already in the pool or repeats an earlier
        # candidate of this batch. An expanded node that was evicted may
        # re-enter and be expanded again, as in the reference.
        in_pool = torch.any(nbrs[:, :, None] == pool_idx[:, None, :], dim=-1)
        dup_in_batch = torch.any((nbrs[:, :, None] == nbrs[:, None, :]) & earlier[None],
                                 dim=-1)
        cscores = torch.where(in_pool | dup_in_batch, NEG_INF, cscores)

        all_idx = torch.cat([pool_idx, nbrs], dim=1)
        all_val = torch.cat([pool_val, cscores], dim=1)
        all_exp = torch.cat([expanded, torch.zeros_like(nbrs, dtype=torch.bool)], dim=1)
        pool_val, top_p = top_k(all_val, pp)
        pool_idx = torch.gather(all_idx, 1, top_p)
        expanded = torch.gather(all_exp, 1, top_p)

    kk = min(k, pp)
    vals, pos = top_k(pool_val, kk)
    idxs = torch.gather(pool_idx, 1, pos)
    if kk < k:
        vals = torch.nn.functional.pad(vals, (0, k - kk), value=NEG_INF)
        idxs = torch.nn.functional.pad(idxs, (0, k - kk), value=0)
    return vals, idxs
