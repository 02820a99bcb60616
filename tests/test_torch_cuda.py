"""Tests of the port that need a CUDA card; each skips without one.

This file imports no JAX (the machine with the card has none), so it runs
there on its own, without the JAX test harness in tests/conftest.py:

    python -m pytest tests/test_torch_cuda.py -q --noconftest

With integer-valued inputs every sum is exact in f32, so there the CUDA
kernels and their plain versions must agree bit for bit, ties included.
"""

import numpy as np
import pytest
import torch

from grape_vector_db_tpu_torch.index import (BinaryDeviceIndex, FlatIndex, GraphDeviceIndex,
                                             Int4IvfDeviceIndex, Int8IvfDeviceIndex,
                                             IvfDeviceIndex, ProjectedInt4IvfIndex,
                                             ProjectedInt8IvfIndex)
from grape_vector_db_tpu_torch.ops import distance as tdist
from grape_vector_db_tpu_torch.ops import gather as tgat
from grape_vector_db_tpu_torch.ops import graph as tgraph
from grape_vector_db_tpu_torch.ops import hamming as tham
from grape_vector_db_tpu_torch.ops import ivf as tivf
from grape_vector_db_tpu_torch.ops import segmax as tseg
from grape_vector_db_tpu_torch.ops.int4 import quantize_int4
from torch_parity import (assert_hits_match, assert_topk_match, integer_case, per_hit,
                          per_row_merge)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


_integer_case = integer_case


@pytest.mark.cuda
@pytest.mark.parametrize("topj", [4, 2])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_segmax_kernel_matches_plain(cuda, topj, dtype):
    v, q, w = _integer_case()
    v, q, w = v.to(cuda).to(getattr(torch, dtype)), q.to(cuda), w.to(cuda)
    kern = tseg.segmax4_scores if topj == 4 else tseg.segmax2_scores
    plain = tseg.segmax4_scores_ref if topj == 4 else tseg.segmax2_scores_ref
    before = tseg.LAUNCHES[f"segmax{topj}"]
    got = kern(q, v, w)
    torch.cuda.synchronize()
    assert tseg.LAUNCHES[f"segmax{topj}"] == before + 1
    for a, b in zip(got, plain(q, v, w)):
        assert torch.equal(a.float(), b.float())


# wrapper, plain version, LAUNCHES key of B9, B10, B7 and B8
VARIANTS = {
    "segmax": (tseg.segmax_scores, tseg.segmax_scores_ref),
    "segmax_contig": (tseg.segmax_scores_contig, tseg.segmax_scores_contig_ref),
    "segmax4_sup": (tseg.segmax4_sup_scores, tseg.segmax4_sup_scores_ref),
    "segmax2_selfold": (lambda q, v, w: tseg.segmax2_scores(q, v, w, impl="selfold"),
                        lambda q, v, w: tseg.segmax2_scores_ref(q, v, w, impl="selfold")),
}


def _planes(x):
    return x if isinstance(x, tuple) else (x,)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_segmax_variant_kernel_matches_plain(cuda, variant, dtype):
    """B7-B10 on the integer case: every plane equal to the plain version's,
    bit for bit (B8's member indices and B7's block maxima included), one
    launch each; B8's i1 differs from B2's on the ties."""
    v, q, w = _integer_case()
    v, q, w = v.to(cuda).to(getattr(torch, dtype)), q.to(cuda), w.to(cuda)
    kern, plain = VARIANTS[variant]
    before = tseg.LAUNCHES[variant]
    got = _planes(kern(q, v, w))
    torch.cuda.synchronize()
    assert tseg.LAUNCHES[variant] == before + 1
    want = _planes(plain(q, v, w))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.shape == b.shape and torch.equal(a.float(), b.float())
    if variant == "segmax2_selfold":
        assert (got[1] != tseg.segmax2_scores(q, v, w)[1]).any()


def _gaussian_segments(cuda, layout, b, d, n):
    """(q, v, w) on the card: Gaussian bf16 rows, normalized queries, the
    cosine weight with 5% of rows invalid, and all rows of segments 0-7 (the
    kernel's first corpus tile in both layouts) and of segment 13 invalid."""
    gen = torch.Generator(device=cuda).manual_seed(b * 100_003 + d * 101 + n)
    v = torch.randn(n, d, device=cuda, generator=gen).to(torch.bfloat16)
    q = torch.nn.functional.normalize(torch.randn(b, d, device=cuda, generator=gen), dim=1)
    w = 1.0 / v.float().norm(dim=1)
    w = torch.where(torch.rand(n, device=cuda, generator=gen) < 0.05, 0.0, w)
    rows = torch.arange(n, device=cuda)
    seg = rows // tseg.SEG if layout == "contig" else (
        rows // tseg.CB * (tseg.CB // tseg.SEG) + rows % (tseg.CB // tseg.SEG))
    w[(seg < 8) | (seg == 13)] = 0.0
    return q, v, w


# the instances of csrc/segmax_max.cu in bf16 storage, by (layout or strided
# variant, top-j): wrapper, plain version, LAUNCHES key (B9, B2, B1, B10, B8, B7)
MAX_KERNELS = {
    ("strided", 1): (tseg.segmax_scores, tseg.segmax_scores_ref, "segmax"),
    ("strided", 2): (tseg.segmax2_scores, tseg.segmax2_scores_ref, "segmax2"),
    ("strided", 4): (tseg.segmax4_scores, tseg.segmax4_scores_ref, "segmax4"),
    ("contig", 1): (*VARIANTS["segmax_contig"], "segmax_contig"),
    ("selfold", 2): (*VARIANTS["segmax2_selfold"], "segmax2_selfold"),
    ("sup", 4): (*VARIANTS["segmax4_sup"], "segmax4_sup"),
}


def _values_then_members(topj, planes):
    """A wrapper's planes as ([value planes, rank 1 first], [member planes])."""
    planes = _planes(planes)
    if topj == 2:                                       # (m1, i1, m2)
        return [planes[0], planes[2]], [planes[1]]
    return list(planes[:topj]), list(planes[topj:])


def _check_topj_planes(topj, got, want, tol=3e-3):
    """-inf where the plain version has it, values within tol, and member
    indices equal wherever both neighbouring rank gaps exceed tol (near ties
    may take either member)."""
    gv, gi = _values_then_members(topj, got)
    wv, wi = _values_then_members(topj, want)
    vals, ref = torch.stack(gv), torch.stack(wv)
    assert vals.shape == ref.shape
    assert torch.equal(torch.isneginf(vals), torch.isneginf(ref))
    fin = torch.isfinite(ref)
    assert fin.any() and (vals - ref)[fin].abs().max().item() <= tol
    for t, (a, b) in enumerate(zip(gi, wi)):
        prev = ref[t - 1] if t else torch.full_like(ref[0], float("inf"))
        sure = torch.minimum(prev - ref[t], ref[t] - ref[t + 1]).nan_to_num(0.0) > tol
        assert a.dtype == b.dtype == torch.int32
        assert torch.equal(a[sure], b[sure])
    return vals


@pytest.mark.cuda
@pytest.mark.parametrize("n", [4096, 8192, 12288])
@pytest.mark.parametrize("d", [128, 384, 768, 1536])
@pytest.mark.parametrize("b", [1, 40, 64, 65, 128, 200, 256])
@pytest.mark.parametrize("layout,topj", list(MAX_KERNELS))
def test_segmax_max_kernel_matches_plain(cuda, layout, topj, b, d, n):
    """B9/B10, B2/B1 (strided top-2 / top-4) and B8/B7 (the same with the
    selfold walk / the block maxima) in bf16 storage (csrc/segmax_max.cu,
    TMA + wgmma) on Gaussian rows: -inf exactly where the plain version has
    it (the all-invalid first tile and segment 13 among them), values
    within 3e-3 (bf16 operands, f32 sums in another order), member indices
    equal away from near ties; one launch. B7's seven planes equal B1's and
    its s1 / s2 the block maxima of its own m1 / m2, and B8's values equal
    B2's, bit for bit: the same main loop and arithmetic."""
    kern, plain, key = MAX_KERNELS[layout, topj]
    q, v, w = _gaussian_segments(cuda, "contig" if layout == "contig" else "strided", b, d, n)
    before = tseg.LAUNCHES[key]
    got = kern(q, v, w)
    torch.cuda.synchronize()
    assert tseg.LAUNCHES[key] == before + 1
    want = plain(q, v, w)
    if layout == "contig":
        got, want = got.T, want.T                       # [B, N/32]
    elif layout == "sup":
        for a, p in zip(got[:7], tseg.segmax4_scores(q, v, w)):
            assert torch.equal(a, p)
        for t in (0, 1):
            s = got[7 + t]
            assert s.shape == want[7 + t].shape == (b, n // tseg.CB)
            assert torch.equal(s, got[t].view(b, -1, tseg.CB // tseg.SEG).amax(dim=2))
            assert torch.equal(torch.isneginf(s), torch.isneginf(want[7 + t]))
            fin = torch.isfinite(s)
            assert (s - want[7 + t])[fin].abs().max().item() <= 3e-3
        got, want = got[:7], want[:7]
    elif layout == "selfold":
        m1, _, m2 = tseg.segmax2_scores(q, v, w)
        assert torch.equal(got[0], m1) and torch.equal(got[2], m2)
    vals = _check_topj_planes(topj, got, want)
    assert torch.isneginf(vals[:, :, :8]).all() and torch.isneginf(vals[:, :, 13]).all()


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 130, 256])
@pytest.mark.parametrize("layout,topj", list(MAX_KERNELS))
def test_segmax_max_kernel_integer_case_is_exact(cuda, layout, topj, b):
    """On the integer case every sum is exact, so B9/B10, B2/B1 and B8/B7 in
    bf16 storage equal their plain versions bit for bit, member indices,
    ties and B7's block maxima included, across one, two and full query
    tiles."""
    kern, plain, _ = MAX_KERNELS[layout, topj]
    v, q, w = _integer_case(b=b)
    v, q, w = v.to(cuda).to(torch.bfloat16), q.to(cuda), w.to(cuda)
    got = _planes(kern(q, v, w))
    torch.cuda.synchronize()
    want = _planes(plain(q, v, w))
    assert len(got) == len(want)
    for a, p in zip(got, want):
        assert a.dtype == p.dtype and torch.equal(a, p)


@pytest.mark.cuda
def test_segmax_max_runs_bf16_only_and_never_falls_back(cuda, monkeypatch):
    """f32 storage runs the csrc/segmax.cu template even when the TMA +
    wgmma library cannot be had; bf16 storage then raises, as it does for a
    w that TMA cannot read (not 16-byte aligned): no path falls back."""
    v, q, w = _integer_case()
    v, q, w = v.to(cuda), q.to(cuda), w.to(cuda)

    def refuse():
        raise RuntimeError("segmax_max withheld")

    monkeypatch.setattr(tseg, "build_max_kernel", refuse)
    for kern, plain in (VARIANTS["segmax"], VARIANTS["segmax_contig"]):
        assert torch.equal(kern(q, v, w), plain(q, v, w))
        with pytest.raises(RuntimeError, match="withheld"):
            kern(q, v.to(torch.bfloat16), w)
    monkeypatch.undo()
    shifted = torch.ones(w.shape[0] + 1, device=cuda)[1:]
    with pytest.raises(ValueError, match="16-byte"):
        tseg.segmax_scores(q, v.to(torch.bfloat16), shifted)


class _FailingLaunch:
    """A stand-in library whose every launch returns cudaErrorLaunchFailure."""

    def gvdb_segmax_max(self, *args):
        return 719

    def gvdb_cuda_error_string(self, code):
        return b"unspecified launch failure"


@pytest.mark.cuda
def test_segmax_topj_bf16_runs_the_tma_kernel_and_never_falls_back(cuda, monkeypatch):
    """B1, B2, B7 and B8 in f32 storage launch the csrc/segmax.cu template
    even when the TMA + wgmma library cannot be had, and in bf16 storage
    they then raise; with the template withheld, bf16 still runs
    (csrc/segmax_max.cu) and f32 raises; the template's C entries refuse
    bf16 outright, and gvdb_segmax_max refuses a combination it has no
    instance for (SUP without out_s among them); and a launch that fails,
    or a w that TMA cannot read, raises without counting a launch."""
    v, q, w = _integer_case()
    v, q, w = v.to(cuda), q.to(cuda), w.to(cuda)
    vb = v.to(torch.bfloat16)
    kernels = [MAX_KERNELS[i] for i in (("strided", 4), ("strided", 2), ("sup", 4),
                                        ("selfold", 2))]

    def refuse():
        raise RuntimeError("library withheld")

    monkeypatch.setattr(tseg, "build_max_kernel", refuse)
    for kern, plain, key in kernels:
        before = tseg.LAUNCHES[key]
        for a, p in zip(kern(q, v, w), plain(q, v, w)):
            assert torch.equal(a, p)
        assert tseg.LAUNCHES[key] == before + 1
        with pytest.raises(RuntimeError, match="withheld"):
            kern(q, vb, w)
    monkeypatch.undo()
    monkeypatch.setattr(tseg, "build_kernels", refuse)
    for kern, plain, key in kernels:
        before = tseg.LAUNCHES[key]
        for a, p in zip(kern(q, vb, w), plain(q, vb, w)):
            assert torch.equal(a, p)
        assert tseg.LAUNCHES[key] == before + 1
        with pytest.raises(RuntimeError, match="withheld"):
            kern(q, v, w)
    monkeypatch.undo()

    lib = tseg.build_kernels()
    b, n, d = q.shape[0], v.shape[0], v.shape[1]
    qb = q.to(torch.bfloat16)
    vals = torch.empty((4, b, n // tseg.SEG), device=cuda)
    idxs = torch.empty((3, b, n // tseg.SEG), dtype=torch.int32, device=cuda)
    sup = torch.empty((2, b, n // tseg.CB), device=cuda)
    ptrs = (qb.data_ptr(), vb.data_ptr(), w.data_ptr(), vals.data_ptr(), idxs.data_ptr())
    stream = torch.cuda.current_stream().cuda_stream
    for topj in (4, 2):
        rc = lib.gvdb_segmax(topj, 0, cuda.index or 0, *ptrs, b, n, d, stream)
        assert rc == 1                                  # cudaErrorInvalidValue
    for variant in (0, 1, 2, 3):
        rc = lib.gvdb_segmax_variant(variant, 0, cuda.index or 0, *ptrs, sup.data_ptr(), b, n,
                                     d, stream)
        assert rc == 1
    mlib = tseg.build_max_kernel()
    # (variant, top-j, out_s): SUP without out_s, then pairs with no instance
    for variant, topj, out_s in ((3, 4, None), (1, 2, sup), (2, 4, sup), (3, 2, sup),
                                 (0, 3, sup), (4, 4, sup)):
        rc = mlib.gvdb_segmax_max(variant, topj, cuda.index or 0, *ptrs,
                                  None if out_s is None else out_s.data_ptr(), b, n, d, stream)
        assert rc == 1

    monkeypatch.setattr(tseg, "build_max_kernel", lambda: _FailingLaunch())
    shifted = torch.ones(w.shape[0] + 1, device=cuda)[1:]
    for kern, _, key in kernels:
        before = tseg.LAUNCHES[key]
        with pytest.raises(RuntimeError, match="launch failed"):
            kern(q, vb, w)
        with pytest.raises(ValueError, match="16-byte"):    # TMA reads w too
            kern(q, vb, shifted)
        assert tseg.LAUNCHES[key] == before


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_segmax_sup_block_maxima_with_an_invalid_block(cuda, dtype):
    """B7 at B = 200 (a ragged second query tile) on the integer case over
    three blocks, the middle one all invalid: s1 / s2 are -inf there and
    finite elsewhere, and every plane equals the plain version bit for bit;
    the query rows past B never reach the block maxima."""
    v, q, w = _integer_case(n=12_288, b=200)
    w[4096:8192] = 0.0
    v, q, w = v.to(cuda).to(getattr(torch, dtype)), q.to(cuda), w.to(cuda)
    got = tseg.segmax4_sup_scores(q, v, w)
    torch.cuda.synchronize()
    want = tseg.segmax4_sup_scores_ref(q, v, w)
    for a, p in zip(got, want):
        assert a.shape == p.shape and a.dtype == p.dtype and torch.equal(a, p)
    for s in got[7:]:
        assert s.shape == (200, 3)
        assert torch.isneginf(s[:, 1]).all() and torch.isfinite(s[:, [0, 2]]).all()


ENTRY_POINTS = {
    "strided": (tseg.segmax_topk, {}, "segmax"),
    "contig": (tseg.segmax_topk, {"layout": "contig"}, "segmax_contig"),
    "segmax4_sup": (tseg.segmax4_topk, {"impl": "sup"}, "segmax4_sup"),
    "segmax2_selfold": (tseg.segmax2_topk, {"impl": "selfold"}, "segmax2_selfold"),
}


@pytest.mark.cuda
@pytest.mark.parametrize("engine", list(ENTRY_POINTS))
@pytest.mark.parametrize("k", [3, 10])
def test_segmax_entry_points_on_cuda_match_cpu(cuda, engine, k):
    """Each entry point on the card (its kernel, one launch) and on the CPU
    (plain versions) returns the same top-k, with a mask; values within
    1e-4 (bf16 rows, f32 sums in different orders)."""
    fn, kw, key = ENTRY_POINTS[engine]
    g = np.random.default_rng(2)
    n, d, b = 12_288, 128, 40
    v = torch.from_numpy(g.standard_normal((n, d)).astype(np.float32)).to(torch.bfloat16)
    q = torch.from_numpy(g.standard_normal((b, d)).astype(np.float32))
    norms = v.float().norm(dim=1)
    valid = torch.from_numpy(g.random(n) > 0.05)
    mask = torch.from_numpy(g.random(n) > 0.3)
    tseg.reset_launch_counts()
    got = fn(q.to(cuda), v.to(cuda), norms.to(cuda), valid.to(cuda), k=k,
             mask=mask.to(cuda), **kw)
    torch.cuda.synchronize()
    assert tseg.LAUNCHES[key] == 1 and sum(tseg.LAUNCHES.values()) == 1
    want = fn(q, v, norms, valid, k=k, mask=mask, **kw)
    assert_topk_match(got[0].cpu(), got[1].cpu(), *want, tol=1e-4)


@pytest.mark.cuda
def test_auto_shard_on_one_gpu_builds_the_unsharded_kind(cuda):
    """ROADMAP C.1: with one GPU, auto_shard builds the kind as asked."""
    if torch.cuda.device_count() > 1:
        pytest.skip("needs a host with exactly one GPU")
    from grape_vector_db_tpu_torch.config import VectorDbConfig
    from grape_vector_db_tpu_torch.db import build_index
    from grape_vector_db_tpu_torch.index import FlatDeviceIndex

    cfg = VectorDbConfig(vector_dimension=128)
    cfg.device.auto_shard = True
    idx = build_index(cfg, device=cuda)
    assert type(idx) is FlatDeviceIndex and idx.device.type == "cuda"


def _probe_case(fmt, n_lists=8, cap=128, d=128, b=24, p=6, seed=0):
    """Small-integer lists, weights of 0.5, 1 and 2 (zeroed inside two
    lists), ragged nblocks (0, odd, past the capacity), duplicate probes."""
    g = np.random.default_rng(seed)
    x = torch.from_numpy(g.integers(-3, 4, (n_lists, cap, d)).astype(np.float32))
    q = torch.from_numpy(g.integers(-3, 4, (b, d)).astype(np.float32))
    w = g.choice([0.5, 1.0, 2.0], (n_lists, cap)).astype(np.float32)
    w[0, 10:30] = 0.0
    w[3, 64:70] = 0.0
    nb = torch.tensor([2, 1, 0, 2, 1, 3, 2, 1], dtype=torch.int32)
    probe = torch.from_numpy(g.integers(0, n_lists, (b, p)).astype(np.int32))
    probe[:, 1] = probe[:, 0]
    if fmt == "bf16":
        data = x.to(torch.bfloat16)
    elif fmt == "int8":
        data = x.to(torch.int8)
    elif fmt == "int4":
        data = quantize_int4(x.reshape(-1, d))[0].reshape(n_lists, cap, d // 2)
    else:
        data = x
    return q, probe, data, torch.from_numpy(w), nb


_PROBES = {"bf16": ("ivf_probe", tivf.ivf_probe_scores, tivf.ivf_probe_scores_ref),
           "f32": ("ivf_probe", tivf.ivf_probe_scores, tivf.ivf_probe_scores_ref),
           "int8": ("ivf_probe_int8", tivf.ivf_probe_scores_int8, tivf.ivf_probe_scores_int8_ref),
           "int4": ("ivf_probe_int4", tivf.ivf_probe_scores_int4, tivf.ivf_probe_scores_int4_ref)}


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", ["bf16", "f32", "int8", "int4"])
def test_ivf_probe_kernel_matches_plain(cuda, fmt):
    name, kern, plain = _PROBES[fmt]
    args = [t.to(cuda) for t in _probe_case(fmt)]
    before, grouped = tivf.LAUNCHES[name], tivf.LAUNCHES["ivf_group"]
    got = kern(*args)
    torch.cuda.synchronize()
    assert tivf.LAUNCHES[name] == before + 1
    # the int8 and int4 probes run their grouping pass first
    assert tivf.LAUNCHES["ivf_group"] == grouped + (fmt in ("int8", "int4"))
    want = plain(*args)
    assert torch.equal(got, want)
    assert (got[args[1] == 2] == -1e9).all()        # list 2 has nblocks 0


def _grouping_case(fmt, kind, d=128, seed=0):
    """An int8 or int4 probe case whose cells group in a given way: "split"
    (one list probed by 21 cells: more than a group holds), "one_list" (every
    cell on one list), "bad_id" (ids -1, L and 2^30 among valid ones),
    "nblocks" (0, a negative count and counts past the capacity). int8 codes
    take every value in [-128, 127]."""
    q, probe, data, w, nb = _probe_case(fmt, d=d, b=24, p=6, seed=seed)
    if fmt == "int8":
        g = np.random.default_rng(seed + 1)
        data = torch.from_numpy(g.integers(-128, 128, tuple(data.shape)).astype(np.int8))
    if kind == "split":
        probe.view(-1)[:21] = 3
    elif kind == "one_list":
        probe[:] = 5
    elif kind == "bad_id":
        probe[0, 2], probe[3, 4], probe[7, 0] = -1, 8, 1 << 30
    elif kind == "nblocks":
        nb = torch.tensor([0, -3, 0, 5, 1, 3, 2, 100], dtype=torch.int32)
    return q, probe, data, w, nb


@pytest.mark.cuda
@pytest.mark.parametrize("d", [32, 128, 384])
@pytest.mark.parametrize("kind", ["split", "one_list", "bad_id", "nblocks"])
def test_ivf_probe_int4_grouping_cases(cuda, kind, d):
    """B5 (grouping pass + grouped kernel) equals its plain version on
    integer data however the cells group; a cell with an id outside [0, L)
    is -1e9 everywhere."""
    q, probe, data, w, nb = (t.to(cuda) for t in _grouping_case("int4", kind, d=d))
    before = dict(tivf.LAUNCHES)
    got = tivf.ivf_probe_scores_int4(q, probe, data, w, nb)
    torch.cuda.synchronize()
    assert tivf.LAUNCHES["ivf_probe_int4"] == before["ivf_probe_int4"] + 1
    assert tivf.LAUNCHES["ivf_group"] == before["ivf_group"] + 1
    assert torch.equal(got, tivf.ivf_probe_scores_int4_ref(q, probe, data, w, nb))
    bad = (probe < 0) | (probe >= w.shape[0])
    assert (got[bad] == -1e9).all()
    if kind == "nblocks":
        assert (got[probe == 0] == -1e9).all() and (got[probe == 1] == -1e9).all()


@pytest.mark.cuda
@pytest.mark.parametrize("d", [16, 128, 384])
@pytest.mark.parametrize("kind", ["split", "one_list", "bad_id", "nblocks"])
def test_ivf_probe_int8_grouping_cases(cuda, kind, d):
    """B4 (grouping pass + persistent grouped kernel) equals its plain version
    on integer data however the cells group, one launch of each a call; a
    cell with an id outside [0, L) is -1e9 everywhere."""
    q, probe, data, w, nb = (t.to(cuda) for t in _grouping_case("int8", kind, d=d))
    before = dict(tivf.LAUNCHES)
    got = tivf.ivf_probe_scores_int8(q, probe, data, w, nb)
    torch.cuda.synchronize()
    assert tivf.LAUNCHES["ivf_probe_int8"] == before["ivf_probe_int8"] + 1
    assert tivf.LAUNCHES["ivf_group"] == before["ivf_group"] + 1
    assert torch.equal(got, tivf.ivf_probe_scores_int8_ref(q, probe, data, w, nb))
    bad = (probe < 0) | (probe >= w.shape[0])
    assert (got[bad] == -1e9).all()
    if kind == "nblocks":
        assert (got[probe == 0] == -1e9).all() and (got[probe == 1] == -1e9).all()


@pytest.mark.cuda
def test_ivf_probe_int8_every_byte_value(cuda):
    """Every int8 value at every position of a 16-byte chunk, scored against
    one-hot queries, comes out as itself: the kernel's byte -> bf16 route is
    exact."""
    d, cap = 128, 256
    codes = ((torch.arange(cap)[:, None] + torch.arange(d)[None, :]) % 256 - 128).to(torch.int8)
    codes = codes.reshape(1, cap, d).to(cuda)
    q = torch.eye(d, device=cuda)
    probe = torch.zeros((d, 1), dtype=torch.int32, device=cuda)
    w = torch.ones((1, cap), device=cuda)
    nb = torch.tensor([cap // 64], dtype=torch.int32, device=cuda)
    got = tivf.ivf_probe_scores_int8(q, probe, codes, w, nb)
    torch.cuda.synchronize()
    assert torch.equal(got[:, 0, :], codes[0].T.float())
    assert torch.equal(got, tivf.ivf_probe_scores_int8_ref(q, probe, codes, w, nb))


@pytest.mark.cuda
@pytest.mark.parametrize("b,p,n_lists", [(1, 1, 1), (24, 6, 8), (128, 16, 4096),
                                         (512, 64, 1000), (3, 5, 70_000)])
def test_group_cells_kernel_matches_plain(cuda, b, p, n_lists):
    """The int4 probe's grouping pass against group_cells_ref: the same bin
    starts, and the same cells in each bin (in any order there)."""
    g = np.random.default_rng(b + p)
    probe = torch.from_numpy(g.integers(-2, n_lists + 2, (b, p)).astype(np.int32))
    probe.view(-1)[: b * p // 3] = n_lists // 2          # a hot list
    before = tivf.LAUNCHES["ivf_group"]
    order, start = tivf.group_cells(probe.to(cuda), n_lists)
    torch.cuda.synchronize()
    assert tivf.LAUNCHES["ivf_group"] == before + 1
    want_order, want_start = tivf.group_cells_ref(probe, n_lists)
    assert torch.equal(start.cpu(), want_start)
    got = order.cpu()
    for k in torch.nonzero(want_start[1:] > want_start[:-1]).reshape(-1).tolist():
        lo, hi = want_start[k].item(), want_start[k + 1].item()
        assert torch.equal(torch.sort(got[lo:hi]).values, torch.sort(want_order[lo:hi]).values)


def _grouped_probe_raises_without_library(cuda, monkeypatch, fmt, cls):
    """A CUDA tensor launches the grouped probe of ``fmt`` or raises; it never
    falls back to the plain version, through the op, the grouping pass or the
    index ``cls``."""
    def no_library():
        raise RuntimeError("nvcc not found")

    name, kern, _ = _PROBES[fmt]
    monkeypatch.setattr(tivf, "build_kernels", no_library)
    q, probe, data, w, nb = (t.to(cuda) for t in _probe_case(fmt))
    before = dict(tivf.LAUNCHES)
    with pytest.raises(RuntimeError, match="nvcc"):
        kern(q, probe, data, w, nb)
    with pytest.raises(RuntimeError, match="nvcc"):
        tivf.group_cells(probe, w.shape[0])
    g = np.random.default_rng(5)
    v = g.standard_normal((5000, 128)).astype(np.float32)
    idx = cls(128, nlist=16, nprobe=4, initial_capacity=2048, device=cuda)
    idx.add_batch([f"d{i}" for i in range(len(v))], v)
    with pytest.raises(RuntimeError, match="nvcc"):
        idx.search_batch(v[:2], 3)
    assert tivf.LAUNCHES == before
    return q, probe, data, w, nb, kern


@pytest.mark.cuda
def test_int4_probe_raises_when_the_kernel_cannot_load(cuda, monkeypatch):
    """A CUDA tensor launches B5 or raises; it never falls back to the plain
    version, through the op, the grouping pass or the index."""
    q, probe, data, w, nb, kern = _grouped_probe_raises_without_library(
        cuda, monkeypatch, "int4", Int4IvfDeviceIndex)
    with pytest.raises(ValueError, match="16 bytes"):
        kern(q[:, :48], probe, data[:, :, :24], w, nb)


@pytest.mark.cuda
def test_int8_probe_raises_when_the_kernel_cannot_load(cuda, monkeypatch):
    """A CUDA tensor launches B4 or raises; it never falls back to the plain
    version, through the op, the grouping pass or the index."""
    q, probe, data, w, nb, kern = _grouped_probe_raises_without_library(
        cuda, monkeypatch, "int8", Int8IvfDeviceIndex)
    with pytest.raises(ValueError, match="16 bytes"):
        kern(q[:, :24], probe, data[:, :, :24], w, nb)


@pytest.mark.cuda
def test_ivf_probe_kernel_refuses_what_it_cannot_load(cuda):
    """A CUDA tensor the kernel cannot take raises; it never falls back."""
    q, probe, data, w, nb = (t.to(cuda) for t in _probe_case("bf16", d=36))
    with pytest.raises(ValueError, match="16 bytes"):
        tivf.ivf_probe_scores(q, probe, data, w, nb)
    with pytest.raises(ValueError, match="CUDA device"):
        tivf.ivf_probe_scores(q, probe.cpu(), data, w, nb)


def _port_state(t):
    """A port IVF index's state as numpy, for load_state (bf16 as f32: the
    values are exact in bf16)."""
    def arr(x):
        return None if x is None else x.float().cpu().numpy() if x.is_floating_point() \
            else x.cpu().numpy()

    o = t._overflow
    st = dict(centroids=arr(t.centroids), norms=arr(t.norms), valid=arr(t.valid),
              list_cap=t.list_cap, next_pos=t._next_pos, free=t._free,
              id_to_cell=t._id_to_cell, vecs=arr(t.vecs), recip=arr(t.recip),
              overflow=dict(vectors=arr(o.vectors), norms=arr(o.norms), valid=arr(o.valid),
                            slot_to_id=o._slot_to_id, free=o._free, high_water=o._high_water))
    if hasattr(t, "codes"):
        st.update(codes=arr(t.codes), scales=arr(t.scales), factor=arr(t.factor))
    return st


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["ivf", "ivf_int8", "ivf_int4"])
def test_ivf_index_on_cuda_matches_cpu(cuda, kind):
    """One IVF state on the CPU (plain versions) and on the card (kernels):
    the same hits for plain, masked and both exhaustive tiers' searches;
    scores within 1e-4 (f32 sums in different orders)."""
    cls = {"ivf": IvfDeviceIndex, "ivf_int8": Int8IvfDeviceIndex,
           "ivf_int4": Int4IvfDeviceIndex}[kind]
    g = np.random.default_rng(2)
    centres = g.standard_normal((20, 128)).astype(np.float32)
    v = (centres[g.integers(0, 20, 5000)] + 0.3 * g.standard_normal((5000, 128))).astype(np.float32)
    q = v[:12] + 0.05 * g.standard_normal((12, 128)).astype(np.float32)
    ids = [f"d{i}" for i in range(len(v))]
    cpu = cls(128, nlist=16, nprobe=4, initial_capacity=2048, device="cpu")
    cpu.add_batch(ids, v)
    cpu.remove_batch(ids[:40])
    card = cls(128, nlist=16, nprobe=4, initial_capacity=2048, device=cuda)
    card.load_state(**_port_state(cpu))
    allowed = set(ids[::7])
    tivf.reset_launch_counts()
    for kw in ({}, {"mask": "in-probe"}, {"mask": "compact"}, {"mask": "streaming"}):
        got = []
        for idx in (card, cpu):
            idx.compact_max_bytes = 0 if kw.get("mask") == "streaming" else 1 << 30
            mask = None if not kw else idx.compile_mask(allowed)
            got.append(idx.search_batch(q, 10, mask=mask,
                                        exhaustive=kw.get("mask") in ("compact", "streaming")))
        for a, b in zip(*got):
            assert [i for i, _ in a] == [i for i, _ in b]
            np.testing.assert_allclose([s for _, s in a], [s for _, s in b], rtol=0, atol=1e-4)
    name = {"ivf": "ivf_probe", "ivf_int8": "ivf_probe_int8", "ivf_int4": "ivf_probe_int4"}[kind]
    assert tivf.LAUNCHES[name] == 3       # plain, in-probe mask, streaming phase 2


@pytest.mark.cuda
@pytest.mark.parametrize("k", [3, 10])
def test_flat_index_on_cuda_matches_cpu(cuda, monkeypatch, k):
    """The same bf16 index on the card (kernel route, thresholds lowered)
    and on the CPU (plain versions) returns the same hits; scores within
    1e-4 (f32 sums in different orders)."""
    monkeypatch.setattr(tdist, "SEGMAX_MIN_ROWS", 4096)
    g = np.random.default_rng(1)
    v = g.standard_normal((6000, 128)).astype(np.float32)
    q = g.standard_normal((16, 128)).astype(np.float32)
    ids = [f"d{i}" for i in range(len(v))]
    tseg.reset_launch_counts()
    hits = []
    for dev in (cuda, "cpu"):
        idx = FlatIndex(128, device=dev)
        idx.add_batch(ids, v)
        idx.remove_batch(ids[:50])
        hits.append(idx.search_batch(q, k))
    assert tseg.LAUNCHES["segmax4" if k >= 4 else "segmax2"] == 1
    for got, want in zip(*hits):
        assert [i for i, _ in got] == [i for i, _ in want]
        np.testing.assert_allclose([s for _, s in got], [s for _, s in want],
                                   rtol=0, atol=1e-4)


def _words(g, rows, w, pattern):
    """[rows, w] int32 words: random bits, or an all-zero, all-one or
    alternating pattern."""
    if pattern == "random":
        return torch.from_numpy(g.integers(-2**31, 2**31, (rows, w), dtype=np.int64)
                                .astype(np.int32))
    val = {"zeros": 0, "ones": -1, "alternating": 0x55555555}[pattern]
    out = np.full((rows, w), val, np.int64)
    out[1::2] ^= 0xFFFFFFFF if pattern == "alternating" else 0
    return torch.from_numpy(out.astype(np.uint32).view(np.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("b,c,w", [(1, 1, 1), (129, 1000, 3), (7, 262_143, 24),
                                   (33, 4097, 24), (2, 513, 5), (128, 262_144, 24),
                                   (256, 262_144, 24), (130, 1030, 48), (3, 777, 70)])
@pytest.mark.parametrize("pattern", ["random", "zeros", "ones", "alternating"])
def test_hamming_kernel_equals_plain(cuda, b, c, w, pattern):
    """B6 against its plain version, integer for integer: C not a multiple
    of 512 (or of the kernel's 128-row tile, or of 4, which the 16-byte
    stores need), W = 1, 3, 5, 24, 48 and 70 (two staged query chunks),
    B = 1 .. 256; the main shape at B = 128 and 256."""
    g = np.random.default_rng(b * 7 + c)
    q = _words(g, b, w, "random" if pattern == "random" else "alternating").to(cuda)
    codes = _words(g, c, w, pattern).to(cuda)
    before = tham.LAUNCHES["hamming"]
    got = tham.hamming_popcount(q, codes)
    torch.cuda.synchronize()
    assert tham.LAUNCHES["hamming"] == before + 1
    assert torch.equal(got, tham.hamming_scores_ref(q, codes))
    assert torch.equal(tham.hamming_scores(q, codes, impl="xla"), got)


@pytest.mark.cuda
def test_popcount_route_raises_when_the_kernel_cannot_load(cuda, monkeypatch):
    """A CUDA tensor launches B6 or raises; it never falls back to the plain
    version, through the op or through the index."""
    def no_library():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(tham, "build_kernels", no_library)
    q = torch.zeros((2, 24), dtype=torch.int32, device=cuda)
    with pytest.raises(RuntimeError, match="nvcc"):
        tham.hamming_scores(q, q, impl="popcount")
    idx = BinaryDeviceIndex(64, hamming_impl="popcount", prescan="hamming", device=cuda)
    idx.add_batch(["a", "b"], np.eye(2, 64, dtype=np.float32))
    with pytest.raises(RuntimeError, match="nvcc"):
        idx.search_batch(np.eye(2, 64, dtype=np.float32), 1)
    with pytest.raises(ValueError, match="int32"):
        tham._launch(q.float(), q)


def _asym_case(cuda, b, c, d, pattern="random", seed=0):
    """A unit bf16 query [b, d] (zero for "zero_query"), [c, ceil(d / 32)]
    int32 codes (random, or all-zero / all-one words) and a mask with about
    a tenth of the rows invalid."""
    g = np.random.default_rng(seed * 7919 + b * 31 + c + d)
    q = g.standard_normal((b, d)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    if pattern == "zero_query":
        q[:] = 0
    w = tham.words_per_vector(d)
    codes = _words(g, c, w, "random" if pattern in ("random", "zero_query") else pattern)
    valid = torch.from_numpy(g.random(c) > 0.1)
    return (torch.from_numpy(q).to(cuda).to(torch.bfloat16), codes.to(cuda), valid.to(cuda))


def _asym_tolerance(qb):
    """[B, 1] allowed gap between the kernel's and the plain version's score:
    each product bf16 x +-1 is exact, and a sum of D of them in f32, in any
    order, lies within D * 2^-24 * sum |q| of the exact sum, so two orders
    lie within twice that."""
    d = qb.shape[1]
    return 2 * d * 2.0**-24 * qb.float().abs().sum(dim=1, keepdim=True)


def _assert_asym_equal(got, want, qb):
    fin = torch.isfinite(want)
    assert torch.equal(torch.isfinite(got), fin)
    assert bool((got[~fin] == float("-inf")).all())
    gap = torch.where(fin, (got - want).abs(), 0.0)
    assert bool((gap <= _asym_tolerance(qb)).all()), float(gap.max())


@pytest.mark.cuda
@pytest.mark.parametrize("c", [1, 1000, 4097, 262_143, 1_048_576])
@pytest.mark.parametrize("b", [1, 7, 8, 9, 128, 256])
def test_asym_kernel_matches_plain(cuda, b, c):
    """The asym kernel against its plain version at D = 768, random codes,
    a tenth of the rows invalid (exactly -inf): B = 1 .. 256 (one, two and
    four n8 tiles a warp, ragged query tiles), C not a multiple of the
    kernel's 128-row tile, up to the 1M capacity the index scores in one
    launch. One launch each."""
    q, codes, valid = _asym_case(cuda, b, c, 768)
    before = tham.LAUNCHES["asym"]
    got = tham.asym_scores(q, codes, valid)
    torch.cuda.synchronize()
    assert tham.LAUNCHES["asym"] == before + 1
    _assert_asym_equal(got, tham.asym_scores_ref(q, codes, valid), q)


@pytest.mark.cuda
@pytest.mark.parametrize("pattern", ["random", "zeros", "ones", "zero_query"])
@pytest.mark.parametrize("d", [768, 64, 100, 1040])
@pytest.mark.parametrize("b,c", [(9, 4097), (128, 1000), (1, 262_143)])
def test_asym_kernel_widths_and_patterns(cuda, b, c, d, pattern):
    """D = 64, 100 (lanes past D in the last word must add nothing), 768 and
    1040 (33 words: two staged chunks, the second of one word); all-zero and
    all-one codes (every sign -1 or +1) and an all-zero query."""
    q, codes, valid = _asym_case(cuda, b, c, d, pattern)
    got = tham.asym_scores(q, codes, valid)
    torch.cuda.synchronize()
    want = tham.asym_scores_ref(q, codes, valid)
    _assert_asym_equal(got, want, q)
    if pattern == "zero_query":
        assert bool((got[torch.isfinite(got)] == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("b,c", [(8, 1_048_576), (128, 262_144)])
def test_asym_kernel_top_r_matches_plain(cuda, b, c):
    """The top-4,096 slots of the kernel's scores and of the plain version's
    are the same rows, except rows whose plain score lies within the gap
    bound of the r-th (where the two sum orders may swap them)."""
    q, codes, valid = _asym_case(cuda, b, c, 768, seed=1)
    got = tham.asym_scores(q, codes, valid)
    want = tham.asym_scores_ref(q, codes, valid)
    r = 4096
    kth = torch.topk(want, r, dim=1).values[:, -1:]
    tol = 2 * _asym_tolerance(q)
    for row in range(b):
        a = set(torch.topk(got[row], r).indices.tolist())
        e = set(torch.topk(want[row], r).indices.tolist())
        for slot in a ^ e:
            assert abs(float(want[row, slot]) - float(kth[row])) <= float(tol[row]), (row, slot)


@pytest.mark.cuda
@pytest.mark.parametrize("keep_vectors", [True, False])
def test_asym_route_raises_when_the_kernel_cannot_load(cuda, monkeypatch, keep_vectors):
    """A CUDA tensor launches the asym kernel or raises; it never falls back
    to the plain version, through the op or through the index (two-stage and
    codes-only)."""
    def no_library():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(tham, "build_asym_kernel", no_library)
    q, codes, valid = _asym_case(cuda, 2, 64, 64)
    before = tham.LAUNCHES["asym"]
    with pytest.raises(RuntimeError, match="nvcc"):
        tham.asym_scores(q, codes, valid)
    with pytest.raises(RuntimeError, match="nvcc"):
        tham.asym_topk(q.float(), codes, valid, k=3)
    idx = BinaryDeviceIndex(64, prescan="asym", keep_vectors=keep_vectors, device=cuda)
    idx.add_batch(["a", "b"], np.eye(2, 64, dtype=np.float32))
    with pytest.raises(RuntimeError, match="nvcc"):
        idx.search_batch(np.eye(2, 64, dtype=np.float32), 1)
    assert tham.LAUNCHES["asym"] == before
    with pytest.raises(ValueError, match="bf16"):
        tham._launch_asym(q.float(), codes, valid)
    with pytest.raises(ValueError, match="disagree"):
        tham._launch_asym(q[:, :32], codes, valid)


@pytest.mark.cuda
@pytest.mark.parametrize("prescan,impl", [("hamming", "popcount"), ("hamming", "mxu"),
                                          ("asym", "mxu")])
def test_binary_index_on_cuda_matches_cpu(cuda, prescan, impl):
    """One binary corpus on the CPU (plain versions) and on the card: the
    same hits; scores within 1e-4 (f32 sums in different orders)."""
    g = np.random.default_rng(3)
    v = g.standard_normal((6000, 128)).astype(np.float32)
    q = v[:12] + 0.1 * g.standard_normal((12, 128)).astype(np.float32)
    ids = [f"d{i}" for i in range(len(v))]
    tham.reset_launch_counts()
    hits = []
    for dev in (cuda, "cpu"):
        idx = BinaryDeviceIndex(128, prescan=prescan, hamming_impl=impl, device=dev)
        idx.add_batch(ids, v)
        idx.remove_batch(ids[:30])
        hits.append((idx.search_batch(q, 10), idx.hamming_only_topk(q, 10)))
    assert tham.LAUNCHES["hamming"] == (2 if impl == "popcount" else 0)
    assert (tham.LAUNCHES["asym"] >= 1) == (prescan == "asym")
    for got, want in zip(*hits):
        for a, b in zip(got, want):
            assert [i for i, _ in a] == [i for i, _ in b]
            np.testing.assert_allclose([s for _, s in a], [s for _, s in b], rtol=0, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("cls,name", [(ProjectedInt8IvfIndex, "ivf_probe_int8"),
                                      (ProjectedInt4IvfIndex, "ivf_probe_int4")])
def test_projected_ivf_runs_the_probe_kernels_at_384(cuda, cls, name):
    """The projected kinds run B4/B5 at D = R = 384 (int4: 192 packed bytes,
    twelve 16-byte chunks a row): kernel scores equal the plain version's
    at the index's own shapes."""
    g = np.random.default_rng(4)
    basis = np.linalg.qr(g.standard_normal((768, 320)))[0].astype(np.float32)
    v = (g.standard_normal((6000, 320)).astype(np.float32) @ basis.T
         + 0.02 * g.standard_normal((6000, 768)).astype(np.float32))
    idx = cls(768, proj_dim=384, nlist=16, nprobe=4, initial_capacity=2048, device=cuda)
    idx.add_batch([f"d{i}" for i in range(len(v))], v)
    assert idx.proj_energy > 0.9
    tivf.reset_launch_counts()
    hits = idx.search_batch(v[:8], 5)
    assert tivf.LAUNCHES[name] == 1 and [row[0][0] for row in hits] == [f"d{i}" for i in range(8)]
    qp = torch.nn.functional.normalize(torch.from_numpy(v[:8]).to(cuda) @ idx.proj, dim=1)
    probe = torch.topk(qp @ idx.centroids.T, 4, dim=1).indices.to(torch.int32)
    kern = tivf.ivf_probe_scores_int8 if name == "ivf_probe_int8" else tivf.ivf_probe_scores_int4
    plain = (tivf.ivf_probe_scores_int8_ref if name == "ivf_probe_int8"
             else tivf.ivf_probe_scores_int4_ref)
    got = kern(qp, probe, idx.codes, idx.factor, idx._nblocks())
    want = plain(qp, probe, idx.codes, idx.factor, idx._nblocks())
    torch.cuda.synchronize()
    assert torch.equal(got == -1e9, want == -1e9)
    assert (got - want)[want != -1e9].abs().max().item() <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("d", [768, 1040, 8192])
def test_int8_dots_on_cuda_are_the_exact_products(cuda, d):
    """int8_topk's product on the card (bf16 x bf16 -> f32, 1040-lane slices
    added in int32 past 1040 lanes) equals the exact integer products cast
    to f32 once, at the default width, at the slice width and past 2^24."""
    from grape_vector_db_tpu_torch.ops import int8 as tint8

    g = np.random.default_rng(5)
    qi = g.integers(100, 128, (8, d)).astype(np.int8)
    codes = g.integers(-127, 128, (1000, d)).astype(np.int8)
    codes[:500] = np.abs(codes[:500])             # sums past 2^24 at d = 8192
    want = (qi.astype(np.int64) @ codes.astype(np.int64).T).astype(np.float32)
    got = tint8._int8_dots(torch.from_numpy(qi).to(cuda).to(torch.bfloat16),
                           torch.from_numpy(codes).to(cuda))
    np.testing.assert_array_equal(got.cpu().numpy(), want)


def _gather_inputs(g, b, c, d, n, integer):
    if integer:
        q = g.integers(-3, 4, (b, d)).astype(np.float32)
        v = g.integers(-3, 4, (n, d)).astype(np.float32)
    else:
        q = g.standard_normal((b, d)).astype(np.float32)
        q /= np.linalg.norm(q, axis=1, keepdims=True)
        v = g.standard_normal((n, d)).astype(np.float32)
    ids = g.integers(0, n, (b, c)).astype(np.int32)
    return torch.from_numpy(q), torch.from_numpy(v), torch.from_numpy(ids)


@pytest.mark.cuda
@pytest.mark.parametrize("b,c,d,n", [(128, 256, 768, 20000), (128, 64, 768, 20000),
                                     (2048, 576, 768, 20000), (5, 37, 100, 300),
                                     (5, 37, 1536, 300), (1, 1, 1, 1),
                                     (1300, 64, 768, 20000), (64, 100, 770, 3000),
                                     (64, 100, 100, 3000)])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("integer", [True, False])
@pytest.mark.parametrize("route", [None, "pairs", "grouped"])
def test_gather_dots_kernel_matches_plain(cuda, b, c, d, n, dtype, integer, route):
    """B11 against its plain version at the beam, entry and build shapes
    (D = 768), through the route the rule picks and through each route
    (the grouped one is bf16's: f32 storage raises there), and at ragged
    shapes (D = 100 and 770: not whole slices; 1536; 1300 queries: three
    query groups): small integers give exact sums, so equal; Gaussian floats
    within 1e-5 of each entry's sum of |q_d v_d| (f32 sums in another
    order)."""
    g = np.random.default_rng(b + c + d)
    q, v, ids = (t.to(cuda) for t in _gather_inputs(g, b, c, d, n, integer))
    v = v.to(getattr(torch, dtype))
    if route == "grouped" and dtype == "float32":
        with pytest.raises(ValueError, match="bf16"):
            tgat.gather_dots(q, v, ids, route=route)
        return
    before = tgat.LAUNCHES["gather_dots"]
    grouped = tgat.LAUNCHES["gather_dots_grouped"]
    got = tgat.gather_dots(q, v, ids, route=route)
    torch.cuda.synchronize()
    assert tgat.LAUNCHES["gather_dots"] == before + 1
    took = route or tgat.gather_route(b, c, d, v.dtype)
    assert tgat.LAUNCHES["gather_dots_grouped"] == grouped + (took == "grouped")
    want = tgat.gather_dots_ref(q, v, ids)
    if integer:
        assert torch.equal(got, want)
    else:
        qr = q.to(v.dtype).float().abs()
        scale = torch.bmm(v.float().abs()[ids.long()], qr[:, :, None])[:, :, 0]
        assert bool(((got - want).abs() <= 1e-5 * scale + 1e-30).all())


def _gather_ids(kind, g, b, c, n):
    """Ids that stress the grouping: one hot row, every pair on its own row,
    heavy repeats within each list, ids far outside [0, n)."""
    if kind == "hot":
        return np.full((b, c), 7, np.int32)
    if kind == "distinct":
        return g.permutation(n)[:b * c].reshape(b, c).astype(np.int32)
    if kind == "repeats":
        return (g.integers(0, 8, (b, c)) * 97 % n).astype(np.int32)
    ids = g.integers(-3 * n, 4 * n, (b, c)).astype(np.int32)
    ids[0, :4] = [-(1 << 31), (1 << 31) - 1, -1, n]
    return ids


@pytest.mark.cuda
@pytest.mark.parametrize("kind,b,c,n", [("hot", 2048, 576, 20000), ("distinct", 128, 256, 40000),
                                        ("repeats", 256, 576, 20000), ("wild", 64, 50, 300)])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("integer", [True, False])
def test_gather_dots_grouping_cases(cuda, kind, b, c, n, dtype, integer):
    """Each route a call can take (pairs; grouped for bf16) against the
    plain version on ids that stress the grouping: integers equal, Gaussian
    floats within 1e-5 of the |q.v| sum; two calls equal bit for bit."""
    g = np.random.default_rng(len(kind) + b)
    q, v, _ = (t.to(cuda) for t in _gather_inputs(g, b, 1, 768, n, integer))
    v = v.to(getattr(torch, dtype))
    ids = torch.from_numpy(_gather_ids(kind, g, b, c, n)).to(cuda)
    want = tgat.gather_dots_ref(q, v, ids)
    qr = q.to(v.dtype).float().abs()
    scale = tgat.gather_dots_ref(qr, v.float().abs(), ids)
    for route in ("pairs", "grouped") if dtype == "bfloat16" else ("pairs",):
        got = tgat.gather_dots(q, v, ids, route=route)
        assert torch.equal(got, tgat.gather_dots(q, v, ids, route=route))
        if integer:
            assert torch.equal(got, want)
        else:
            assert bool(((got - want).abs() <= 1e-5 * scale + 1e-30).all())


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["pairs", "grouped"])
@pytest.mark.parametrize("b,c", [(0, 37), (5, 0)])
def test_gather_dots_empty_launches_nothing(cuda, route, b, c):
    q = torch.zeros((b, 64), device=cuda)
    v = torch.ones((10, 64), device=cuda, dtype=torch.bfloat16)
    ids = torch.zeros((b, c), dtype=torch.int32, device=cuda)
    before = dict(tgat.LAUNCHES)
    out = tgat.gather_dots(q, v, ids, route=route)
    assert out.shape == (b, c) and out.dtype == torch.float32
    assert tgat.LAUNCHES == before


@pytest.mark.cuda
@pytest.mark.parametrize("kind,b,c,n", [("wild", 64, 50, 300), ("hot", 2048, 576, 20000),
                                        ("repeats", 1300, 64, 20000), ("distinct", 3, 3000, 9000),
                                        ("wild", 0, 5, 30), ("wild", 5, 0, 30)])
def test_group_pairs_kernel_matches_plain(cuda, kind, b, c, n):
    """The card's grouping pass against its plain version: rep equal (a list
    longer than MAX_DEDUP_COLUMNS keeps every copy on the card), the same
    first copies, each (query group, row) key one contiguous run of
    ``order``, the query groups in order."""
    g = np.random.default_rng(b + c)
    ids = torch.from_numpy(_gather_ids(kind, g, b, c, n)).to(cuda) if b * c else \
        torch.zeros((b, c), dtype=torch.int32, device=cuda)
    before = tgat.LAUNCHES["gather_group"]
    order, rep, totals = tgat.group_pairs(ids, n)
    assert tgat.LAUNCHES["gather_group"] == before + 1
    ref_order, ref_rep, ref_totals = tgat.group_pairs_ref(ids, n)
    cols = torch.arange(c, device=cuda).expand(b, c)
    if c > tgat.MAX_DEDUP_COLUMNS:
        ref_rep = cols.to(torch.int32)
        first = torch.arange(b * c, device=cuda)
        ref_totals = torch.bincount(first // c // tgat.GROUP_QUERIES,
                                    minlength=ref_totals.numel()).to(torch.int32)
    else:
        first = torch.sort(ref_order[:int(ref_totals.sum())].long()).values
    assert torch.equal(rep, ref_rep) and torch.equal(totals, ref_totals)
    got = order[:int(totals.sum())].long()
    assert torch.equal(torch.sort(got).values, first)
    rows = (ids.clamp(0, n - 1).long()
            + (torch.arange(b, device=cuda) // tgat.GROUP_QUERIES * n)[:, None]).reshape(-1)
    keys = rows[got]
    if keys.numel():
        assert int((keys[1:] != keys[:-1]).sum()) + 1 == int(torch.unique(keys).numel())
        assert bool((keys[1:] // n >= keys[:-1] // n).all())


@pytest.mark.cuda
def test_gather_dots_grouped_raises(cuda, monkeypatch):
    """The grouped route takes bf16 storage only, and never falls back to the
    plain version: a failed build raises."""
    g = np.random.default_rng(12)
    q, v, ids = (t.to(cuda) for t in _gather_inputs(g, 4, 8, 96, 50, True))
    with pytest.raises(ValueError, match="bf16"):
        tgat.gather_dots(q, v, ids, route="grouped")
    with pytest.raises(ValueError, match="route"):
        tgat.gather_dots(q, v, ids, route="sorted")

    def no_library():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(tgat, "build_kernels", no_library)
    with pytest.raises(RuntimeError, match="nvcc"):
        tgat.gather_dots(q, v.to(torch.bfloat16), ids, route="grouped")
    with pytest.raises(RuntimeError, match="nvcc"):
        tgat.group_pairs(ids, 50)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_gather_dots_kernel_clamps_and_raises(cuda, monkeypatch, dtype):
    """Negative and too-large ids read rows 0 and N-1 in the kernel as in the
    plain version; a CUDA tensor never falls back to the plain version."""
    g = np.random.default_rng(9)
    q, v, _ = (t.to(cuda) for t in _gather_inputs(g, 4, 1, 96, 50, True))
    v = v.to(getattr(torch, dtype))
    ids = torch.tensor([[0, -1, 5, 50], [49, -7, 60, -1], [1, 2, 3, 1 << 30],
                        [-(1 << 30), 49, 0, 48]], dtype=torch.int32, device=cuda)
    got = tgat.gather_dots(q, v, ids, impl="pallas")
    assert torch.equal(got, tgat.gather_dots_ref(q, v, ids))
    assert torch.equal(got, tgat.gather_dots(q, v, ids.clamp(0, 49), impl="pallas_interpret"))
    with pytest.raises(ValueError, match="int32"):
        tgat.gather_dots(q, v, ids.long())
    with pytest.raises(ValueError, match="CUDA device"):
        tgat.gather_dots(q.cpu(), v, ids)

    def no_library():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(tgat, "build_kernels", no_library)
    with pytest.raises(RuntimeError, match="nvcc"):
        tgat.gather_dots(q, v, ids)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_graph_build_and_beam_on_cuda_equal_cpu(cuda, dtype):
    """Integer data with the dot metric: the build and the beam on the card
    (B11 in every step) equal the CPU's (plain versions), id for id and
    value for value."""
    g = np.random.default_rng(10)
    v = torch.from_numpy(g.integers(-2, 3, (3000, 32)).astype(np.float32)).to(
        getattr(torch, dtype))
    valid = torch.from_numpy(g.random(3000) >= 0.05)
    norms = torch.linalg.vector_norm(v.float(), dim=1)
    q = torch.from_numpy(g.integers(-2, 3, (16, 32)).astype(np.float32))
    entries = torch.arange(0, 3000, 97, dtype=torch.int32)
    out = []
    tgat.reset_launch_counts()
    for dev in ("cpu", cuda):
        args = [t.to(dev) for t in (v, norms, valid)]
        nb = tgraph.build_knn_graph(*args, m=16, rounds=5, nn_sample=8, chunk=1024,
                                    metric="dot")
        vals, idxs = tgraph.beam_search(q.to(dev), *args, entries.to(dev),
                                        torch.from_numpy(nb).to(dev), k=10, pool=64,
                                        expand=8, iters=8, metric="dot")
        out.append((nb, vals.cpu(), idxs.cpu()))
    assert tgat.LAUNCHES["gather_dots"] == 5 * 3 + 1 + 8   # 5 rounds x 3 chunks, entry, iters
    np.testing.assert_array_equal(out[0][0], out[1][0])
    assert torch.equal(out[0][1], out[1][1]) and torch.equal(out[0][2], out[1][2])


@pytest.mark.cuda
def test_graph_index_on_cuda_matches_cpu(cuda):
    """One graph state on the CPU and on the card: the same hits through the
    k-means entry probe, the beam (B11), the fresh region and a delete;
    scores within 1e-4 and ids up to near ties within it (f32 sums in
    different orders)."""
    g = np.random.default_rng(11)
    v = g.standard_normal((5000, 64)).astype(np.float32)
    ids = [f"d{i}" for i in range(len(v))]
    cpu = GraphDeviceIndex(64, device="cpu")
    cpu.add_batch(ids[:4800], v[:4800])
    cpu.optimize()
    cpu.add_batch(ids[4800:], v[4800:])
    cpu.remove_batch(ids[:30])
    assert cpu.centroids is not None and cpu.get_stats().extra["fresh"] == 200

    def flat(f):
        return dict(vectors=f.vectors.float().numpy(), norms=f.norms.numpy(),
                    valid=f.valid.numpy(), slot_to_id=f._slot_to_id, free=f._free,
                    high_water=f._high_water)

    card = GraphDeviceIndex(64, device=cuda)
    card.load_state(graph_store=flat(cpu._graph_store), fresh=flat(cpu._fresh),
                    neighbors=cpu.neighbors.numpy(), entries=None,
                    centroids=cpu.centroids.numpy(), reps=cpu.reps.numpy(),
                    graph_n=cpu._graph_n, nb_cap=cpu._nb_cap, builds=cpu.builds)
    q = v[20:36] + 0.1 * g.standard_normal((16, 64)).astype(np.float32)
    tgat.reset_launch_counts()
    got = card.search_batch(q, 10)
    assert tgat.LAUNCHES["gather_dots"] == 1 + card.search_iters
    assert_hits_match(got, cpu.search_batch(q, 10), 1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("dim,buckets,chunk", [(768, 32768, 1024), (128, 4096, 7)])
def test_device_embedder_on_cuda_matches_cpu(cuda, dim, buckets, chunk):
    """The embedder's device step on the card against the same step on the
    CPU: the same projection bit for bit, f32 rows within 1e-5 (the same bf16
    products summed in another order), f16 rows within one f16 ulp; the f16
    copy reaches the host through pinned memory."""
    from grape_vector_db_tpu_torch.services.device_embedder import DeviceHashEmbedder

    texts = [f"theme {i % 7} document {i} about replication and consensus {i * 31 % 97}"
             for i in range(40)] + ["", "naïve café", "a" * 300]
    card = DeviceHashEmbedder(dim=dim, buckets=buckets, chunk=chunk, device=cuda)
    cpu = DeviceHashEmbedder(dim=dim, buckets=buckets, chunk=chunk, device="cpu")
    assert torch.equal(card._projection().cpu().view(torch.int16),
                       cpu._projection().view(torch.int16))
    c_chunks, c_drain = card.embed_ingest(texts)
    h_chunks, h_drain = cpu.embed_ingest(texts)
    for (c, nv), (h, hv) in zip(c_chunks, h_chunks):
        assert c.is_cuda and c.dtype == torch.float32 and nv == hv
        np.testing.assert_allclose(c[:nv].cpu().numpy(), h[:hv].numpy(), rtol=0, atol=1e-5)
    a, b = c_drain(), h_drain()
    big = np.maximum(np.abs(a), np.abs(b)).astype(np.float16)
    assert (np.abs(a.astype(np.float32) - b.astype(np.float32))
            <= np.spacing(big).astype(np.float32)).all()


@pytest.mark.cuda
@pytest.mark.parametrize("storage_dtype", ["bfloat16", "float32"])
def test_add_batch_device_matches_add_batch_on_cuda(cuda, storage_dtype):
    """Device rows written by add_batch_device (two chunks with padding rows
    past n_valid) land as add_batch writes the same rows: equal planes,
    norms, validity and hits."""
    g = np.random.default_rng(5)
    rows = g.standard_normal((300, 96)).astype(np.float32)
    ids = [f"r{i}" for i in range(300)]
    host = FlatIndex(96, storage_dtype=storage_dtype, initial_capacity=128, device=cuda)
    host.add_batch(ids, rows)
    dev = FlatIndex(96, storage_dtype=storage_dtype, initial_capacity=128, device=cuda)
    pad = torch.full((20, 96), float("nan"), device=cuda)
    chunks = [(torch.cat([torch.from_numpy(rows[:200]).to(cuda), pad]), 200),
              (torch.cat([torch.from_numpy(rows[200:]).to(cuda), pad]), 100)]
    dev.add_batch_device(ids, chunks)
    torch.cuda.synchronize()
    assert dev.capacity == host.capacity and len(dev) == 300
    assert torch.equal(dev.vectors, host.vectors)
    assert torch.equal(dev.norms, host.norms) and torch.equal(dev.valid, host.valid)
    q = rows[:16] + 0.1 * g.standard_normal((16, 96)).astype(np.float32)
    assert dev.search_batch(q, 10) == host.search_batch(q, 10)


@pytest.mark.cuda
def test_server_on_cuda_answers_each_group(cuda, monkeypatch):
    """A small bf16 database on the card behind the gRPC and REST servers
    answers one RPC of each group; with the segment route lowered to its
    8192 rows, an unfiltered search through the micro-batcher runs B1 and
    comes back exact against a product on the card."""
    import json
    import urllib.request

    from grape_vector_db_tpu_torch import VectorDatabase, VectorDbConfig
    from grape_vector_db_tpu_torch.server.grpc_server import VectorDbClient, build_grpc_server
    from grape_vector_db_tpu_torch.server.proto import vector_db_pb2 as pb
    from grape_vector_db_tpu_torch.server.rest import RestServer

    monkeypatch.setattr(tdist, "SEGMAX_MIN_ROWS", 4096)
    cfg = VectorDbConfig(vector_dimension=128)
    cfg.index.initial_capacity = 8192
    db = VectorDatabase(config=cfg, device=cuda)
    server, port, servicer = build_grpc_server(db, port=0)
    server.start()
    rest = RestServer(db, port=0)
    host, rport = rest.start()
    client = VectorDbClient(f"127.0.0.1:{port}")
    try:
        x = np.random.default_rng(9).standard_normal((8000, 128)).astype(np.float32)
        for s in range(0, 8000, 2000):
            resp = client.upsert_points([pb.Point(id=f"p{i}", vector=pb.Vector(values=x[i]),
                                                  payload={"g": str(i % 4)})
                                         for i in range(s, s + 2000)])
            assert resp.upserted == 2000 and not resp.error
        before = tseg.LAUNCHES["segmax4"]
        got = client.search(x[7].tolist(), limit=10, with_payload=False)
        assert tseg.LAUNCHES["segmax4"] > before and servicer.batcher.queries_run == 1
        xs = torch.from_numpy(x).to(cuda).to(torch.bfloat16).float()
        s = torch.nn.functional.normalize(xs, dim=1) @ torch.nn.functional.normalize(
            torch.from_numpy(x[7]).to(cuda), dim=0)
        vals, rows = torch.topk(s, 10)
        assert_hits_match([[(r.id, r.score) for r in got.results]],
                          [[(f"p{int(i)}", float(v)) for i, v in zip(rows, vals)]], 3e-3)
        flt = client.search(x[7].tolist(), limit=5, filter_sql="g = 3")
        assert len(flt.results) == 5 and all(r.payload["g"] == "3" for r in flt.results)
        assert client.call("GetVector", pb.GetVectorRequest(id="p7")).found
        assert client.call("DeleteVector", pb.DeleteVectorRequest(ids=["p7"])).deleted == 1
        assert client.call("AddDocument", pb.AddDocumentRequest(documents=[
            pb.Document(id="doc", content="served on the card")])).ids == ["doc"]
        assert not client.call("SearchDocuments", pb.SearchDocumentsRequest(
            query="card", mode="text")).error
        assert client.call("GetClusterInfo", pb.GetClusterInfoRequest()).cluster_id == "standalone"
        assert not client.call("RequestVote", pb.RequestVoteRequest(term=1)).vote_granted
        assert client.call("GetShardInfo", pb.GetShardInfoRequest()).point_count == 8000
        assert client.call("GetStats", pb.GetStatsRequest()).document_count == 8000
        text = client.call("GetMetrics", pb.GetMetricsRequest()).prometheus_text
        hbm = [line for line in text.splitlines() if "hbm_bytes_in_use" in line
               and not line.startswith("#")]
        assert hbm and float(hbm[0].split()[-1]) > 0
        with urllib.request.urlopen(f"http://{host}:{rport}/health", timeout=30) as r:
            assert json.loads(r.read())["status"] == "healthy"
        body = json.dumps({"mode": "vector", "vector": x[8].tolist(), "limit": 3}).encode()
        req = urllib.request.Request(f"http://{host}:{rport}/api/v1/search", data=body,
                                     method="POST")
        with urllib.request.urlopen(req, timeout=30) as r:
            assert json.loads(r.read())["results"][0]["id"] == "p8"
    finally:
        client.close()
        rest.stop()
        server.stop(grace=0)
        db.close()


@pytest.mark.cuda
def test_cluster_legs_run_b1_on_the_card(cuda):
    """A 3-node, 16-shard, RF=2 cluster with every index on the card and
    ~300k rows a node: each shard-local leg of a scatter-gather search runs
    B1, and the merged answers are exact against an f32 product on the card."""
    from grape_vector_db_tpu_torch import Document, VectorDbConfig
    from grape_vector_db_tpu_torch.distributed.cluster_service import ClusterService
    from grape_vector_db_tpu_torch.distributed.types import (ClusterConfig, ConsistencyLevel,
                                                             SessionToken)

    n, d = 450_000, 128
    svc = ClusterService(["node-1", "node-2", "node-3"],
                         ClusterConfig(shard_count=16, replica_count=2,
                                       consistency=ConsistencyLevel.SESSION),
                         VectorDbConfig(vector_dimension=d), device=cuda)
    svc.start()
    try:
        rng = np.random.default_rng(15)
        x = rng.standard_normal((n, d), dtype=np.float32)
        tok = SessionToken()
        for s in range(0, n, 8192):
            svc.upsert([Document(id=f"p{i}", content="", vector=x[i])
                        for i in range(s, min(n, s + 8192))], session=tok)
        rows = [node.db.store.count() for node in svc.nodes.values()]
        assert sum(rows) == 2 * n and min(rows) >= tdist.SEGMAX_MIN_ROWS, rows
        q = x[:8] + 0.1 * rng.standard_normal((8, d), dtype=np.float32)
        before = tseg.LAUNCHES["segmax4"]
        got = svc.search_batch(q.tolist(), k=10, session=tok)
        single = svc.search(q[0].tolist(), k=10, session=tok)
        assert tseg.LAUNCHES["segmax4"] >= before + 6   # one a node, twice
        xs = torch.nn.functional.normalize(torch.from_numpy(x).to(cuda).to(torch.bfloat16)
                                           .float(), dim=1)
        s = torch.nn.functional.normalize(torch.from_numpy(q).to(cuda), dim=1) @ xs.T
        vals, ids = torch.topk(s, 10, dim=1)
        want = [[(f"p{int(i)}", float(v)) for i, v in zip(ir, vr)]
                for ir, vr in zip(ids.cpu(), vals.cpu())]
        assert_hits_match(got, want, 3e-3)
        assert_hits_match([single], want[:1], 3e-3)
    finally:
        svc.stop()


@pytest.mark.cuda
@pytest.mark.parametrize("k,key", [(10, "segmax4"), (3, "segmax2")])
def test_sharded_flat_runs_the_segment_kernel_on_every_shard(cuda, k, key):
    """``sharded_flat`` over a mesh of four entries of one card, 4 shards of
    524,288 rows' capacity: every search runs B1 (k >= 4) or B2 (k <= 3) once
    a shard, and the merged answers are exact against an f32 product of the
    bf16-rounded rows on the card (ids with the near-tie guard, 3e-3)."""
    from grape_vector_db_tpu_torch.parallel import ShardedFlatIndex, make_mesh

    n, d = 600_000, 128
    idx = ShardedFlatIndex(d, mesh=make_mesh(4, devices=[cuda]), shard_capacity=524_288)
    assert idx.device.type == "cuda" and idx.n_shards == 4
    rng = np.random.default_rng(16)
    x = rng.standard_normal((n, d), dtype=np.float32)
    idx.add_batch([f"p{i}" for i in range(n)], x)
    q = x[:16] + 0.1 * rng.standard_normal((16, d), dtype=np.float32)
    tseg.reset_launch_counts()
    got = idx.search_batch(q, k)
    torch.cuda.synchronize()
    assert tseg.LAUNCHES[key] == 4 and sum(tseg.LAUNCHES.values()) == 4
    xs = torch.nn.functional.normalize(torch.from_numpy(x).to(cuda).to(torch.bfloat16).float(),
                                       dim=1)
    s = torch.nn.functional.normalize(torch.from_numpy(q).to(cuda), dim=1) @ xs.T
    vals, ids = torch.topk(s, k, dim=1)
    want = [[(f"p{int(i)}", float(v)) for i, v in zip(ir, vr)]
            for ir, vr in zip(ids.cpu(), vals.cpu())]
    assert_hits_match(got, want, 3e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["ivf", "ivf_int8", "ivf_int4"])
def test_sharded_ivf_probe_runs_on_every_shard(cuda, kind):
    """The sharded IVF kinds over four entries of one card: a search runs
    the kind's probe kernel (B3, B4 or B5, the last two after their grouping
    pass) once a shard, and answers as the same index on a CPU mesh with the
    same centroids (plain versions there): ids with the near-tie guard,
    3e-3."""
    from grape_vector_db_tpu_torch.parallel import (ShardedInt4IvfIndex, ShardedInt8IvfIndex,
                                                    ShardedIvfIndex, make_mesh)

    cls = {"ivf": ShardedIvfIndex, "ivf_int8": ShardedInt8IvfIndex,
           "ivf_int4": ShardedInt4IvfIndex}[kind]
    key = {"ivf": "ivf_probe", "ivf_int8": "ivf_probe_int8", "ivf_int4": "ivf_probe_int4"}[kind]
    n, d = 40_000, 128
    rng = np.random.default_rng(17)
    centres = rng.standard_normal((64, d), dtype=np.float32)
    x = centres[rng.integers(0, 64, n)] + 0.3 * rng.standard_normal((n, d), dtype=np.float32)
    ids = [f"p{i}" for i in range(n)]
    out = []
    for dev in (cuda, torch.device("cpu")):
        idx = cls(d, mesh=make_mesh(4, devices=[dev]), nlist=64, nprobe=8,
                  initial_capacity=2 * n)
        if out:
            idx.centroids = out[0][0].centroids.cpu()
        idx.add_batch(ids, x)
        q = out[0][2] if out else x[:16] + 0.05 * rng.standard_normal((16, d), dtype=np.float32)
        tivf.reset_launch_counts()
        hits = idx.search_batch(q, 10)
        if dev.type == "cuda":
            torch.cuda.synchronize()
            assert tivf.LAUNCHES[key] == 4
            assert tivf.LAUNCHES["ivf_group"] == (0 if kind == "ivf" else 4)
        out.append((idx, hits, q))
    assert out[1][0]._id_to_cell == out[0][0]._id_to_cell
    assert_hits_match(out[0][1], out[1][1], 3e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["flat", "binary", "int8"])
def test_device_window_and_device_time_come_from_the_event_pair(cuda, kind):
    """Each call's ``device`` span is its pair of CUDA events on the span
    clock, inside the call's index span, and the always-on device time is
    the sum of the pairs' elapsed times."""
    from grape_vector_db_tpu_torch import Document, VectorDatabase, VectorDbConfig
    from grape_vector_db_tpu_torch.utils import tracing

    rows, dim = 16384, 128
    cfg = VectorDbConfig(vector_dimension=dim)
    cfg.index.kind = kind
    db = VectorDatabase(config=cfg, device="cuda")
    x = np.random.default_rng(9).standard_normal((rows, dim)).astype(np.float32)
    db.batch_add_documents([Document(id=str(i), vector=x[i]) for i in range(rows)])
    db.vector_search_batch(x[:4], 10)
    before = db.index.counters()["device_time_ms_total"]
    assert before > 0
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]):
        for j in range(4):
            assert db.vector_search_batch(x[j:j + 1], 10)[0][0].id == str(j)
    spent = db.index.counters()["device_time_ms_total"] - before
    records = tracing.spans()
    windows = [s for s in records if s.name == tracing.DEVICE]
    index = {s.span_id: s for s in records if s.name == "index"}
    assert len(windows) == 4 and len(index) == 4
    slack = 50_000   # ns: the anchor's error
    for w in windows:
        parent = index[w.parent_id]
        assert w.call_id == parent.call_id
        assert parent.t0_ns - slack <= w.t0_ns < w.t1_ns <= parent.t1_ns + slack
    span_ms = sum(w.t1_ns - w.t0_ns for w in windows) / 1e6
    assert spent > 0 and abs(span_ms - spent) <= 0.002 * len(windows)
    text = db.metrics.prometheus_text()
    line = next(v for v in text.splitlines()
                if v.startswith("grape_vector_db_device_time_ms_total "))
    assert float(line.split()[-1]) == pytest.approx(before + spent)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["flat", "binary", "ivf", "ivf_overflow"])
def test_bulk_hits_on_the_card_equal_the_per_hit_loop(cuda, monkeypatch, kind):
    """The hits a search builds from the arrays it read back from the card
    equal the per-hit loop's over the same arrays, in order: the 1,000 x 10
    batch of the benchmark's batch cells and one query at k=100, over
    131,072 clustered 768-d rows (IVF: 64 lists of 1,024, so a quarter of
    the rows sit in the overflow until ``optimize()``)."""
    rng = np.random.default_rng(24)
    n, d = 131_072, 768
    centers = rng.standard_normal((512, d)).astype(np.float32)
    x = centers[rng.integers(0, 512, n)] + 0.25 * rng.standard_normal((n, d)).astype(np.float32)
    ids = [str(i) for i in range(n)]
    q = np.concatenate([x[:8], x[rng.integers(0, n, 992)] + 0.05])
    ivf = kind.startswith("ivf")
    if ivf:
        idx = IvfDeviceIndex(d, nlist=64, nprobe=16, initial_capacity=65_536, device=cuda)
    else:
        cls = FlatIndex if kind == "flat" else BinaryDeviceIndex
        idx = cls(d, initial_capacity=n, device=cuda)
    for lo in range(0, n, 16_384):
        idx.add_batch(ids[lo:lo + 16_384], x[lo:lo + 16_384])
    idx.remove_batch(ids[::97])
    if kind == "ivf":
        idx.optimize()
    calls = []

    def record(name):
        orig = getattr(idx, name)

        def wrapped(*args):
            out = orig(*args)
            calls.append((args, out))
            return out

        monkeypatch.setattr(idx, name, wrapped)

    record("_hits" if ivf else "hits_from_slots")
    got = [idx.search_batch(q, 10), idx.search_batch(q[:1], 100)]
    assert len(calls) == 2
    for g, (args, out) in zip(got, calls):
        assert g is out
        if ivf:
            vals, slots, _, o_hits, k = args
            cells = {lst * idx.list_cap + pos: i for i, (lst, pos) in idx._id_to_cell.items()}
            want = per_row_merge(per_hit(vals, slots, cells.get),
                                 o_hits or [[] for _ in range(len(vals))], k)
        else:
            vals, slots = args
            want = per_hit(vals, slots, idx._slot_to_id.__getitem__)
        assert g == want
    merged = idx.counters()["ivf_overflow_merge_rows_total"] if ivf else 0
    assert merged == (1001 if kind == "ivf_overflow" else 0)
