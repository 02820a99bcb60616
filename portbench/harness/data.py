"""The general generator: a deployment's corpus and a traffic mix's queries,
made from ``--seed`` on the device in a few large calls.

A configuration's ``dataset`` block gives the corpus recipe (rows, width,
Gaussian centres and the noise around them); a traffic file gives the query
set (its size and, optionally, a share that lies near stored rows with the
noise around them) and the batch. The same seed gives the same tensors, bit for bit, so
the reference regenerates the corpus after the window instead of keeping it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np
import torch

_MASK63 = (1 << 63) - 1
# rows made in one step of the in-place noise + centre sum
_BLOCK = 131072


def stream_seed(seed: int, stream: int) -> int:
    """A 63-bit generator seed for one stream of draws of ``seed``: the corpus
    and the queries draw from separate streams, so a traffic mix never
    changes the corpus."""
    return (int(seed) * 0x9E3779B97F4A7C15 + stream * 0xBF58476D1CE4E5B9 + 1) & _MASK63


@dataclass
class Corpus:
    x: torch.Tensor          # [rows, dim] f32 on the device
    centres: torch.Tensor    # [centres, dim] f32 on the device
    checksum: float          # f64 sum of x, to prove a regeneration equal


def make_corpus(ds: dict, seed: int, device) -> Corpus:
    """``ds["rows"]`` points, each a uniformly drawn one of ``ds["centres"]``
    standard-normal centres plus ``ds["noise"]`` times standard-normal noise
    (the recipe of the 1M IVF configuration, ``bench.py:483-506``)."""
    rows, dim = int(ds["rows"]), int(ds["dim"])
    g = torch.Generator(device=device)
    g.manual_seed(stream_seed(seed, 0))
    centres = torch.randn((int(ds["centres"]), dim), generator=g, device=device)
    cid = torch.randint(0, centres.shape[0], (rows,), generator=g, device=device)
    x = torch.randn((rows, dim), generator=g, device=device)
    for lo in range(0, rows, _BLOCK):
        x[lo:lo + _BLOCK].mul_(float(ds["noise"])).add_(centres[cid[lo:lo + _BLOCK]])
    return Corpus(x, centres, float(x.sum(dtype=torch.float64)))


def make_queries(corpus: Corpus, ds: dict, traffic: dict, seed: int) -> np.ndarray:
    """The mix's query set as host f32 ``[query_set, dim]``: the first
    ``near_share`` of it (default none) stored rows plus ``near_noise``
    noise, the rest held out: fresh draws from the corpus's centres with the
    corpus's own noise, as a benchmark's test set is drawn apart from its
    train set."""
    x, centres = corpus.x, corpus.centres
    n = int(traffic["query_set"])
    n_near = int(round(n * float(traffic.get("near_share", 0.0))))
    g = torch.Generator(device=x.device)
    g.manual_seed(stream_seed(seed, 1))
    near = torch.randperm(x.shape[0], generator=g, device=x.device)[:n_near]
    q_near = x[near] + float(traffic.get("near_noise", 0.0)) * torch.randn(
        (n_near, x.shape[1]), generator=g, device=x.device)
    cid = torch.randint(0, centres.shape[0], (n - n_near,), generator=g, device=x.device)
    q_fresh = centres[cid] + float(ds["noise"]) * torch.randn(
        (n - n_near, x.shape[1]), generator=g, device=x.device)
    return torch.cat([q_near, q_fresh]).cpu().numpy()


def batch_rows(n_queries: int, batch: int) -> List[np.ndarray]:
    """Row numbers of each distinct batch: call j takes the ``batch`` queries
    after the ``j * batch``-th, in turn and wrapping, so the batches repeat
    after ``n_queries / gcd(n_queries, batch)`` calls."""
    period = n_queries // np.gcd(n_queries, batch)
    return [(j * batch + np.arange(batch)) % n_queries for j in range(period)]
