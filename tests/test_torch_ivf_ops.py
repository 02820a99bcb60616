"""Parity of the port's IVF ops with the JAX package, on the CPU.

The same numpy inputs (made from a seed) go through the JAX function and its
counterpart in ``grape_vector_db_tpu_torch.ops``. The Pallas probe kernels run
in interpret mode (``interpret=True``), as tests/test_ivf.py runs them; the
port runs the kernels' plain PyTorch versions, which is what its wrappers do
for CPU tensors. The JAX weight planes are ``[L, 8, C]``, the port's ``[L, C]``.

Tolerances: probe scores 3e-3 for bf16, int8 and int4 lists (bf16 operands,
f32 sums in different orders; the repo's on-chip tolerance), 1e-5 for f32
lists; top-k results as id sets with the near-tie guard
(tests/torch_parity.py). Quantized codes and scales compare bit for bit.
"""

from importlib import import_module

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grape_vector_db_tpu.ops import ivf_pallas as jivf
from grape_vector_db_tpu.ops import ivf_scan as jscan
from grape_vector_db_tpu.ops.int4 import quantize_int4 as jq4
from grape_vector_db_tpu.ops.int4 import unpack_int4 as junpack4
from grape_vector_db_tpu.ops.int8 import quantize_int8 as jq8
from grape_vector_db_tpu.ops.kmeans import assign_clusters as j_assign
from grape_vector_db_tpu.ops.kmeans import kmeans as j_kmeans
from grape_vector_db_tpu_torch.ops import ivf as tivf
from grape_vector_db_tpu_torch.ops import ivf_scan as tscan
from grape_vector_db_tpu_torch.ops.int4 import quantize_int4 as tq4
from grape_vector_db_tpu_torch.ops.int4 import unpack_int4 as tunpack4
from grape_vector_db_tpu_torch.ops.int8 import quantize_int8 as tq8
from torch_parity import assert_close, assert_topk_match, to_np

# the module, not the function the ops package exports under the same name
tkm = import_module("grape_vector_db_tpu_torch.ops.kmeans")

torch.set_num_threads(2)

L, C, D, B = 8, 128, 64, 4
TOL = {"bf16": 3e-3, "f32": 1e-5, "int8": 3e-3, "int4": 3e-3}


def _t(x):
    return torch.from_numpy(np.array(x))


def _plane8(w):
    """The reference's [L, 8, C] layout of a [L, C] weight plane."""
    return jnp.broadcast_to(jnp.asarray(w)[:, None, :], (w.shape[0], 8, w.shape[1]))


def _lists(rng, fmt, d=D):
    """[L, C, width] list data in the JAX and torch types, a [L, C] weight
    plane that is 0 past each list's high-water mark and in a run inside
    list 0, and ragged nblocks (0, odd and full counts)."""
    nb = np.array([2, 1, 0, 2, 1, 2, 2, 1], np.int32)
    x = rng.standard_normal((L * C, d)).astype(np.float32)
    w = rng.uniform(0.5, 2.0, (L, C)).astype(np.float32)
    for lst in range(L):
        w[lst, 64 * nb[lst]:] = 0.0
    w[0, 10:20] = 0.0
    if fmt == "int8":
        data = np.asarray(jq8(jnp.asarray(x))[0]).reshape(L, C, d)
        return jnp.asarray(data), _t(data), w, nb
    if fmt == "int4":
        data = np.asarray(jq4(jnp.asarray(x))[0]).reshape(L, C, d // 2)
        return jnp.asarray(data), _t(data), w, nb
    x = x.reshape(L, C, d)
    if fmt == "f32":
        return jnp.asarray(x), _t(x), w, nb
    return jnp.asarray(x).astype(jnp.bfloat16), _t(x).to(torch.bfloat16), w, nb


_JAX_PROBE = {"bf16": jivf.ivf_probe_scores, "f32": jivf.ivf_probe_scores,
              "int8": jivf.ivf_probe_scores_int8, "int4": jivf.ivf_probe_scores_int4}
_PORT_REF = {"bf16": tivf.ivf_probe_scores_ref, "f32": tivf.ivf_probe_scores_ref,
             "int8": tivf.ivf_probe_scores_int8_ref, "int4": tivf.ivf_probe_scores_int4_ref}
_PORT_WRAP = {"bf16": tivf.ivf_probe_scores, "f32": tivf.ivf_probe_scores,
              "int8": tivf.ivf_probe_scores_int8, "int4": tivf.ivf_probe_scores_int4}

# duplicate list ids inside a row, and a list probed by every query
PROBE = np.array([[0, 1, 2, 0, 3], [4, 5, 6, 7, 7], [2, 2, 2, 1, 0], [3, 4, 5, 6, 2]],
                 np.int32)


def _assert_scores(got, want, tol):
    got, want = to_np(got), np.asarray(want)
    np.testing.assert_array_equal(got == -1e9, want == -1e9)
    live = want != -1e9
    assert_close(got[live], want[live], tol)


# int8 also at D = 384, the width the projected kinds probe at
@pytest.mark.parametrize("fmt,d", [("bf16", D), ("f32", D), ("int8", D), ("int4", D),
                                   ("int8", 384)],
                         ids=["bf16", "f32", "int8", "int4", "int8-d384"])
def test_probe_ref_matches_pallas(rng, fmt, d):
    jdata, tdata, w, nb = _lists(rng, fmt, d)
    q = rng.standard_normal((B, d)).astype(np.float32)
    want = _JAX_PROBE[fmt](jnp.asarray(q), jnp.asarray(PROBE), jdata, _plane8(w),
                           nblocks=jnp.asarray(nb), interpret=True)
    got = _PORT_REF[fmt](_t(q), _t(PROBE), tdata, _t(w), _t(nb))
    assert got.shape == (B, PROBE.shape[1], C) and got.dtype == torch.float32
    _assert_scores(got, want, TOL[fmt])
    # the wrapper takes the plain version for CPU tensors
    assert torch.equal(_PORT_WRAP[fmt](_t(q), _t(PROBE), tdata, _t(w), _t(nb)), got)
    # list 2 has nblocks 0: every cell of it is invalid
    assert (to_np(got)[PROBE == 2] == -1e9).all()


def test_int8_unpack_route_is_exact_on_every_byte():
    """The int8 probe kernel's byte -> bf16 route, emulated bit for bit in
    numpy on all 256 byte values: u = s ^ 0x80 placed under 0x4B0000 is the
    f32 2^23 + u; subtracting 2^23 + 128 leaves s exactly, with the low 16
    bits of the float zero, so its high half is s in bf16."""
    s = np.arange(-128, 128, dtype=np.int32)
    u = (s & 0xFF) ^ 0x80
    f = (u | 0x4B000000).astype(np.uint32).view(np.float32)
    x = f - np.float32(8388736.0)                      # f32 arithmetic, as the kernel's fadd
    assert x.dtype == np.float32
    np.testing.assert_array_equal(x, s.astype(np.float32))
    bits = x.view(np.uint32)
    assert (bits & 0xFFFF == 0).all()                  # exact in bf16
    hi = (bits >> 16).astype(np.uint16)                # the prmt of the high halves
    np.testing.assert_array_equal(
        hi, torch.from_numpy(s.astype(np.float32)).to(torch.bfloat16).view(torch.int16)
        .numpy().view(np.uint16))
    np.testing.assert_array_equal((hi.astype(np.uint32) << 16).view(np.float32), s)


def test_probe_ref_honours_nblocks_without_zero_weights(rng):
    """The row limit alone marks rows invalid: rows past 64 * nblocks score
    -1e9 even where the weight plane is not 0, and a too large count clamps
    to the list capacity."""
    x = rng.integers(-3, 4, (L, C, D)).astype(np.float32)
    q = rng.integers(-3, 4, (B, D)).astype(np.float32)
    w = np.ones((L, C), np.float32)
    nb = np.array([1, 5, 0, 2, 1, 2, 2, 1], np.int32)
    got = to_np(tivf.ivf_probe_scores_ref(_t(q), _t(PROBE), _t(x), _t(w), _t(nb)))
    lim = np.minimum(64 * nb, C)
    dots = np.einsum("bd,bpcd->bpc", q, x[PROBE])
    want = np.where(np.arange(C)[None, None, :] < lim[PROBE][:, :, None], dots, -1e9)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("rescore", [0, 40])
@pytest.mark.parametrize("masked", [False, True])
def test_finalize_probe_topk_matches_jax(rng, masked, rescore):
    jdata, tdata, w, nb = _lists(rng, "bf16")
    q = rng.standard_normal((B, D)).astype(np.float32)
    qp = q / np.linalg.norm(q, axis=1, keepdims=True)
    # a deduped probe (the finalize contract assumes distinct lists per row)
    probe = np.array([[0, 1, 3, 4], [4, 5, 6, 7], [2, 1, 0, 3], [3, 4, 5, 6]], np.int32)
    scores = to_np(tivf.ivf_probe_scores_ref(_t(qp), _t(probe), tdata, _t(w), _t(nb)))
    mask = rng.random((L, C)) < 0.6 if masked else None
    want = jivf.finalize_probe_topk(
        jnp.asarray(qp), jnp.asarray(probe), jnp.asarray(scores), 10, "cosine",
        cell_mask=None if mask is None else jnp.asarray(mask), rescore=rescore,
        vecs=jdata if rescore else None,
        weight_fn=(lambda rl, rp: _plane8(w)[rl, 0, rp]) if rescore else None)
    got = tivf.finalize_probe_topk(
        _t(qp), _t(probe), _t(scores), 10, "cosine",
        cell_mask=None if mask is None else _t(mask), rescore=rescore,
        vecs=tdata if rescore else None,
        weight_fn=(lambda rl, rp: _t(w)[rl, rp]) if rescore else None)
    assert_topk_match(*got, *want, tol=3e-3)
    if mask is not None:
        slots = to_np(got[1])[np.isfinite(to_np(got[0]))]
        assert mask.reshape(-1)[slots].all()


def test_quantizers_and_unpack_bit_equal_jax(rng):
    x = (rng.standard_normal((500, D)) * rng.uniform(0.1, 10, (500, 1))).astype(np.float32)
    for xj, xt in ((jnp.asarray(x), _t(x)),
                   (jnp.asarray(x).astype(jnp.bfloat16), _t(x).to(torch.bfloat16))):
        for jq, tq in ((jq8, tq8), (jq4, tq4)):
            jc, js = jq(xj)
            tc, ts = tq(xt)
            assert tc.dtype == torch.int8
            np.testing.assert_array_equal(to_np(tc), np.asarray(jc))
            np.testing.assert_array_equal(to_np(ts), np.asarray(js))
    packed = np.asarray(jq4(jnp.asarray(x))[0])
    np.testing.assert_array_equal(to_np(tunpack4(_t(packed))),
                                  np.asarray(junpack4(jnp.asarray(packed))))


@pytest.mark.parametrize("metric", ["cosine", "dot"])
def test_weight_planes_match_jax(rng, metric):
    norms = rng.uniform(0.0, 3.0, (L, C)).astype(np.float32)
    norms[0, :5] = 0.0
    valid = rng.random((L, C)) < 0.7
    scales = rng.uniform(0.01, 0.1, (L, C)).astype(np.float32)
    np.testing.assert_array_equal(
        to_np(tivf.make_recip(_t(norms), _t(valid), metric)),
        np.asarray(jivf.make_recip(jnp.asarray(norms), jnp.asarray(valid), metric))[:, 0, :])
    np.testing.assert_array_equal(
        to_np(tivf.make_factor(_t(scales), _t(norms), _t(valid), metric)),
        np.asarray(jivf.make_factor(jnp.asarray(scales), jnp.asarray(norms),
                                    jnp.asarray(valid), metric))[:, 0, :])
    counts = np.array([0, 1, 63, 64, 65, 128, 200, 5])
    np.testing.assert_array_equal(to_np(tivf.nblocks_from_counts(counts)),
                                  np.asarray(jivf.nblocks_from_counts(counts)))


def _clustered(rng, n, k, d, spread=0.1):
    centers = rng.standard_normal((k, d)).astype(np.float32) * 3
    return (centers[rng.integers(0, k, n)]
            + spread * rng.standard_normal((n, d)).astype(np.float32)).astype(np.float32)


@pytest.mark.parametrize("mode", ["spherical", "l2"])
def test_assign_clusters_matches_jax_away_from_ties(rng, mode):
    x = rng.standard_normal((3000, D)).astype(np.float32)
    cents = rng.standard_normal((50, D)).astype(np.float32)
    if mode == "spherical":
        cents /= np.linalg.norm(cents, axis=1, keepdims=True)
    want = np.asarray(j_assign(jnp.asarray(x), jnp.asarray(cents), mode=mode))
    got = to_np(tkm.assign_clusters(_t(x), _t(cents), mode=mode, chunk_rows=700))
    assert got.dtype == np.int32
    if mode == "spherical":
        aff = (x / np.linalg.norm(x, axis=1, keepdims=True)) @ cents.T
    else:
        aff = -((x[:, None, :] - cents[None]) ** 2).sum(-1)
    top2 = -np.sort(-aff, axis=1)[:, :2]
    sure = top2[:, 0] - top2[:, 1] > 1e-4 * np.maximum(1.0, np.abs(top2[:, 0]))
    assert sure.mean() > 0.9
    np.testing.assert_array_equal(got[sure], want[sure])


@pytest.mark.parametrize("chunk", [None, 250])
@pytest.mark.parametrize("mode", ["spherical", "l2"])
def test_lloyd_from_shared_start_matches_jax(rng, mode, chunk):
    """JAX's kmeans draws its start with jax.random.choice; the same draw is
    made here and handed to the port's Lloyd iterations."""
    n, k, iters, seed = 1000, 16, 6, 3
    x = _clustered(rng, n, 12, D)
    want, _ = j_kmeans(jnp.asarray(x), k=k, iters=iters, seed=seed, mode=mode, chunk=chunk)
    init = np.asarray(jax.random.choice(jax.random.PRNGKey(seed), n, shape=(k,), replace=False))
    got = tkm.lloyd(_t(x), _t(x[init]), iters=iters, mode=mode, chunk=chunk)
    np.testing.assert_allclose(to_np(got), np.asarray(want), rtol=0, atol=1e-4)
    cents, assign = tkm.kmeans(_t(x), k=k, iters=iters, seed=seed, mode=mode, chunk=chunk)
    assert cents.shape == (k, D) and assign.shape == (n,)
    with pytest.raises(ValueError, match="multiple"):
        tkm.lloyd(_t(x), _t(x[init]), iters=1, mode=mode, chunk=300)


def _scan_state(rng, fmt):
    """A bucketed layout with ragged lists, deletes and a filter mask."""
    jdata, tdata, _, nb = _lists(rng, fmt)
    valid = np.zeros((L, C), bool)
    for lst in range(L):
        valid[lst, :64 * nb[lst] - 3 if nb[lst] else 0] = True
    valid[1, 5:9] = False
    norms = rng.uniform(0.5, 3.0, (L, C)).astype(np.float32)
    if fmt == "bf16":
        plane = np.asarray(jivf.make_recip(jnp.asarray(norms), jnp.asarray(valid)))[:, 0, :]
    else:
        scales = rng.uniform(0.01, 0.1, (L, C)).astype(np.float32)
        plane = np.asarray(jivf.make_factor(jnp.asarray(scales), jnp.asarray(norms),
                                            jnp.asarray(valid)))[:, 0, :]
    mask = rng.random((L, C)) < 0.3
    return jdata, tdata, plane, nb, mask


@pytest.mark.parametrize("fmt", ["bf16", "int8", "int4"])
def test_exhaustive_and_compact_tiers_match_jax(rng, fmt):
    jdata, tdata, plane, nb, mask = _scan_state(rng, fmt)
    q = rng.standard_normal((8, D)).astype(np.float32)
    k = 10
    want = jscan.ivf_exhaustive_masked_topk(
        jnp.asarray(q), jdata, _plane8(plane), jnp.asarray(mask), k=k, fmt=fmt,
        chunk_lists=2, use_kernel=True, interpret=True, nblocks=jnp.asarray(nb))
    got = tscan.ivf_exhaustive_masked_topk(
        _t(q), tdata, _t(plane), _t(mask), k=k, fmt=fmt, chunk_lists=2, nblocks=_t(nb))
    assert_topk_match(*got, *want, tol=3e-3)
    allowed = mask & (plane != 0)
    assert allowed.reshape(-1)[to_np(got[1])[np.isfinite(to_np(got[0]))]].all()

    cells = np.flatnonzero(mask.reshape(-1))
    padded = np.full(1024, -1, np.int32)      # the reference's power-of-two bucket
    padded[:len(cells)] = cells
    want = jscan.ivf_compact_masked_topk(jnp.asarray(q), jdata, _plane8(plane),
                                         jnp.asarray(padded), k=k, fmt=fmt)
    rows, w = tscan.compact_gather(tdata, _t(plane), _t(cells))
    got = tscan.compact_topk_from_rows(_t(q), rows, w, _t(cells), k=k, fmt=fmt,
                                       chunk_rows=37)
    assert_topk_match(*got, *want, tol=3e-3)
    # the streaming and compact tiers agree with each other too
    assert_topk_match(*got, *tscan.ivf_exhaustive_masked_topk(
        _t(q), tdata, _t(plane), _t(mask), k=k, fmt=fmt, nblocks=_t(nb)), tol=3e-3)


@pytest.mark.parametrize("fmt", ["bf16", "int8", "int4"])
def test_reference_calls_of_the_exact_tiers_match_jax(rng, fmt):
    """ROADMAP C.7: the reference's calls run unchanged on the port:
    ``ivf_compact_masked_topk`` on the -1-padded cell bucket and
    ``ivf_exhaustive_masked_topk`` with ``use_kernel`` / ``interpret``, both
    with the [L, 8, C] plane (read back from JAX) and the [L, C] one."""
    jdata, tdata, plane, nb, mask = _scan_state(rng, fmt)
    q = rng.standard_normal((8, D)).astype(np.float32)
    k = 10
    cells = np.flatnonzero(mask.reshape(-1))
    padded = np.full(1024, -1, np.int32)
    padded[:len(cells)] = cells
    want = jscan.ivf_compact_masked_topk(jnp.asarray(q), jdata, _plane8(plane),
                                         jnp.asarray(padded), k=k, fmt=fmt)
    for tplane in (_t(np.asarray(_plane8(plane))), _t(plane)):
        got = tscan.ivf_compact_masked_topk(_t(q), tdata, tplane, _t(padded), k=k, fmt=fmt)
        assert_topk_match(*got, *want, tol=3e-3)
        assert (to_np(got[1]) >= 0).all()
    want = jscan.ivf_exhaustive_masked_topk(
        jnp.asarray(q), jdata, _plane8(plane), jnp.asarray(mask), k=k, fmt=fmt,
        chunk_lists=2, use_kernel=True, interpret=True, nblocks=jnp.asarray(nb))
    got = tscan.ivf_exhaustive_masked_topk(
        _t(q), tdata, _t(np.asarray(_plane8(plane))), _t(mask), k, "cosine", fmt, 2, True,
        True, _t(nb))
    assert_topk_match(*got, *want, tol=3e-3)
    # an all-pad bucket answers -inf everywhere
    empty = tscan.ivf_compact_masked_topk(_t(q), tdata, _t(plane), _t(np.full(64, -1)), k=k,
                                          fmt=fmt)
    assert torch.isneginf(empty[0]).all() and empty[0].shape == (8, k)


def test_probe_dup_mask_and_chunk_lists_match_jax():
    probe = np.array([[3, 0, 3, 0, 7], [1, 2, 3, 4, 5]], np.int32)
    np.testing.assert_array_equal(to_np(tscan.probe_dup_mask(_t(probe))),
                                  np.asarray(jscan.probe_dup_mask(jnp.asarray(probe))))
    for nlist, cap in ((4096, 768), (8, 128), (64, 4096), (1000, 256)):
        assert tscan.default_chunk_lists(nlist, cap) == jscan.default_chunk_lists(nlist, cap)


def test_probe_kernel_refuses_cpu_tensors():
    """The kernel path takes CUDA tensors only: a CPU tensor reaches the
    plain version through the wrapper, never the launcher."""
    with pytest.raises(ValueError, match="CUDA"):
        tivf._launch("bf16", torch.zeros(2, D), torch.zeros(2, 3, dtype=torch.int32),
                     torch.zeros(L, C, D, dtype=torch.bfloat16), torch.ones(L, C), None)


@pytest.mark.parametrize("b,p,n_lists", [(1, 1, 1), (24, 6, 8), (128, 16, 4096), (7, 3, 2)])
def test_group_cells_ref_matches_a_numpy_ordering(rng, b, p, n_lists):
    """The plain version of the int4 probe's grouping pass: the cells b * P +
    p stably ordered by list (ids outside [0, L) last, in bin L), and the
    bins' first positions."""
    probe = rng.integers(-2, n_lists + 2, (b, p)).astype(np.int32)
    probe.reshape(-1)[: b * p // 3] = n_lists // 2          # a hot list
    order, start = tivf.group_cells_ref(_t(probe), n_lists)
    ids = probe.reshape(-1)
    bins = np.where((ids >= 0) & (ids < n_lists), ids, n_lists)
    want = np.argsort(bins, kind="stable")
    assert order.dtype == torch.int32 and start.dtype == torch.int32
    np.testing.assert_array_equal(to_np(order), want)
    counts = np.bincount(bins, minlength=n_lists + 1)
    np.testing.assert_array_equal(to_np(start), np.concatenate([[0], np.cumsum(counts)]))
    # the CPU wrapper takes the plain version
    assert all(torch.equal(x, y) for x, y in zip(tivf.group_cells(_t(probe), n_lists),
                                                (order, start)))


@pytest.mark.parametrize("fmt", ["bf16", "int8", "int4"])
def test_probe_ref_scores_unknown_ids_invalid(rng, fmt):
    """A probe id outside [0, L) scores -1e9 on its whole cell; the other
    cells score as they do without it."""
    jdata, tdata, w, nb = _lists(rng, fmt)
    q = _t(rng.standard_normal((B, D)).astype(np.float32))
    bad = PROBE.copy()
    bad[0, 1], bad[2, 0], bad[3, 2] = -1, L, 1 << 30
    got = to_np(_PORT_REF[fmt](q, _t(bad), tdata, _t(w), _t(nb)))
    want = to_np(_PORT_REF[fmt](q, _t(PROBE), tdata, _t(w), _t(nb)))
    unknown = (bad < 0) | (bad >= L)
    assert (got[unknown] == -1e9).all()
    np.testing.assert_array_equal(got[~unknown], want[~unknown])
