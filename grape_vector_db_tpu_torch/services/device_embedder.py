"""On-device text embedder: feature hashing + a projection on the card.

PyTorch counterpart of ``grape_vector_db_tpu/services/device_embedder.py``.
The reference's offline provider is a per-text hash fixture
(``MockEmbeddingProvider``), which gives unrelated vectors to near-identical
texts. This embedder is deterministic and local, and its vectors carry
lexical similarity, with the heavy math on the device.

Method (the hashing trick, fastText-shaped but training-free):

1. Host featurization: word tokens (``engine.sparse.SimpleTokenizer``, the
   BM25 channel's lowercasing, stopwords and CJK rules) plus character
   n-grams (3..5) over each token. Each feature string hashes to a bucket in
   ``[0, buckets)`` (crc32) and a +-1 sign (a second crc32 salt).
2. Device step, one batch chunk at a time: scatter-add the (bucket,
   sign * log(1 + tf)) pairs into a ``[B, buckets]`` f32 plane, multiply its
   bf16 cast by a fixed seeded gaussian projection ``[buckets, dim]`` with f32
   out, L2-normalize. The projection preserves the hashed-space cosine, so
   similar texts land near each other.

The projection is the JAX package's, bit for bit
(``utils/jax_random.normal_bf16``), so the two packages embed a text to the
same vector up to the sums' order. Same text, same vector, across runs and
processes.
"""

from __future__ import annotations

import threading
import zlib
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from grape_vector_db_tpu_torch.engine.sparse import SimpleTokenizer
from grape_vector_db_tpu_torch.ops.distance import f32_dots
from grape_vector_db_tpu_torch.services.embeddings import EmbeddingProvider
from grape_vector_db_tpu_torch.utils.jax_random import normal_bf16

__all__ = ["DeviceHashEmbedder"]

# One projection per (buckets, dim, seed, device), shared across embedder
# instances so a db and its query path do not hold two 48 MB planes.
_PROJ_CACHE: Dict[Tuple[int, int, int, str], torch.Tensor] = {}
_PROJ_LOCK = threading.Lock()

_HASH_LIB = None
_HASH_LIB_READY = False


def _native_hash_lib():
    """ctypes handle with gvdb_hash_features configured, or None (missing
    toolchain / stale .so without the symbol -> Python featurizer)."""
    global _HASH_LIB, _HASH_LIB_READY
    with _PROJ_LOCK:
        if _HASH_LIB_READY:
            return _HASH_LIB
        _HASH_LIB_READY = True
        try:
            import ctypes

            from grape_vector_db_tpu_torch.engine.sparse import _native_text_lib

            lib = _native_text_lib()
            if lib is None:
                _HASH_LIB = None
                return None
            fn = lib.gvdb_hash_features  # AttributeError -> stale .so
            fn.restype = ctypes.c_int32
            i32p = ctypes.POINTER(ctypes.c_int32)
            fn.argtypes = [
                ctypes.c_char_p, i32p, ctypes.c_int32,      # texts, offsets, n
                ctypes.c_char_p, ctypes.c_int32,            # salt
                ctypes.c_int32, ctypes.c_int32,             # lo_n, hi_n
                ctypes.c_int32, ctypes.c_int32,             # buckets, m
                i32p, ctypes.POINTER(ctypes.c_float),       # out idx/val
            ]
            _HASH_LIB = lib
        except Exception:
            _HASH_LIB = None
        return _HASH_LIB


class DeviceHashEmbedder(EmbeddingProvider):
    """Deterministic local embedder: signed feature hashing, then a
    projection on ``device``.

    Parameters mirror ``EmbeddingConfig``: ``dimension`` is the output width,
    ``buckets`` the hashed feature space (more buckets = fewer collisions),
    ``max_features`` the per-text feature budget (texts keep their
    most-frequent features; ties break on bucket id so truncation is
    deterministic), ``ngram`` the character n-gram span taken over each word
    token, ``chunk`` the texts one device step takes.
    """

    def __init__(self, dim: int = 768, buckets: int = 32_768, seed: int = 0,
                 max_features: int = 256, ngram: Tuple[int, int] = (3, 5),
                 chunk: int = 1024, device: str | torch.device = "cuda"):
        if dim <= 0 or buckets <= 0:
            raise ValueError("dim and buckets must be positive")
        self._dim = dim
        self._buckets = buckets
        self._seed = seed
        self._max_features = max_features
        self._ngram = ngram
        self._chunk = chunk
        self.device = torch.device(device)
        self._tokenizer = SimpleTokenizer()
        self._seed_salt = f"|{seed}".encode()

    # -- EmbeddingProvider surface -------------------------------------------

    def dimension(self) -> int:
        return self._dim

    def generate_embeddings(self, texts: Sequence[str]) -> List[List[float]]:
        return [row.tolist() for row in self.embed_array(texts)]

    def embed_array(self, texts: Sequence[str]) -> np.ndarray:
        """Batch embed to a float32 ``[len(texts), dim]`` array. The rows
        are the f16 copies the store keeps (see ``embed_ingest``), so they
        carry f16 rounding (~5e-4 relative on unit rows), deterministically."""
        if not texts:
            return np.zeros((0, self._dim), np.float32)
        _, drain = self.embed_ingest(texts)
        return drain().astype(np.float32)

    def embed_ingest(self, texts: Sequence[str]):
        """Ingest-path embedding: ``(chunks, drain)``.

        ``chunks`` is ``[(device f32 [rows, dim], n_valid), ...]``, the
        normalized outputs still on the device, for a device-direct index
        write (``FlatDeviceIndex.add_batch_device``) with no host round trip.
        Their f16 copies start to the host (pinned memory, on the current
        stream) as each chunk is issued; ``drain()`` waits for them and
        returns the ``[len(texts), dim]`` float16 rows the document store
        keeps, so the copy overlaps the caller's index write and host work.
        """
        if not texts:
            return [], lambda: np.zeros((0, self._dim), np.float16)
        idx, val = self._featurize(texts)
        proj = self._projection()
        chunks, parts = [], []
        for lo in range(0, len(texts), self._chunk):
            hi = min(lo + self._chunk, len(texts))
            e32, e16 = self._embed_chunk(idx[lo:hi], val[lo:hi], proj)
            if e16.is_cuda:
                host = torch.empty(e16.shape, dtype=e16.dtype, pin_memory=True)
                host.copy_(e16, non_blocking=True)
                done = torch.cuda.Event()
                done.record()
            else:
                host, done = e16, None
            chunks.append((e32, hi - lo))
            parts.append((lo, hi, host, done))

        def drain() -> np.ndarray:
            out = np.empty((len(texts), self._dim), np.float16)
            for lo, hi, host, done in parts:
                if done is not None:
                    done.synchronize()
                out[lo:hi] = host.numpy()
            return out

        return chunks, drain

    # -- featurization (host) --------------------------------------------------

    def _features(self, text: str) -> Dict[int, float]:
        lo_n, hi_n = self._ngram
        acc: Dict[int, int] = {}
        for tok in self._tokenizer.tokenize(text):
            feats = [tok]
            padded = f"<{tok}>"
            for n in range(lo_n, hi_n + 1):
                if len(padded) < n:
                    break
                feats.extend(padded[i:i + n] for i in range(len(padded) - n + 1))
            for f in feats:
                raw = f.encode() + self._seed_salt
                b = zlib.crc32(raw) % self._buckets
                # signed-key encoding: +b for sign +1, -(b+1) for sign -1 —
                # opposite-sign hits on one bucket cancel in the scatter-add,
                # which is exactly the unbiased signed hashing trick
                key = b if zlib.crc32(b"#" + raw) & 1 else -(b + 1)
                acc[key] = acc.get(key, 0) + 1
        # log-damped term frequency, signed
        return {k: float(np.log1p(c)) for k, c in acc.items()}

    def _featurize(self, texts: Sequence[str]) -> Tuple[np.ndarray, np.ndarray]:
        m = self._max_features
        idx = np.zeros((len(texts), m), np.int32)
        val = np.zeros((len(texts), m), np.float32)
        # ASCII texts take the native loop (the exact-parity featurizer in
        # native/gvdb_text.cpp::gvdb_hash_features); non-ASCII stays here so
        # Unicode behavior is single-sourced, the BM25 tokenizer's split.
        remaining = range(len(texts))
        lib = _native_hash_lib()
        if lib is not None:
            ascii_ids = [i for i in remaining if texts[i].isascii()]
            if ascii_ids and self._hash_native(lib, texts, ascii_ids, idx, val):
                aset = set(ascii_ids)
                remaining = [i for i in range(len(texts)) if i not in aset]
        for i in remaining:
            feats = self._features(texts[i])
            if not feats:
                continue
            items = sorted(feats.items(), key=lambda kv: (-kv[1], kv[0]))[:m]
            for j, (key, w) in enumerate(items):
                if key >= 0:
                    idx[i, j], val[i, j] = key, w
                else:
                    idx[i, j], val[i, j] = -key - 1, -w
        return idx, val

    def _hash_native(self, lib, texts: Sequence[str], ids, idx: np.ndarray,
                     val: np.ndarray) -> bool:
        """Featurize ``texts[ids]`` (all ASCII) through the C++ loop into the
        matching rows of ``idx``/``val``. False -> caller falls back."""
        import ctypes

        m = self._max_features
        blobs = [texts[i].encode("ascii") for i in ids]
        offsets = np.zeros(len(blobs) + 1, np.int32)
        np.cumsum([len(b) for b in blobs], out=offsets[1:])
        concat = b"".join(blobs)
        sub_idx = np.zeros((len(blobs), m), np.int32)
        sub_val = np.zeros((len(blobs), m), np.float32)
        lo_n, hi_n = self._ngram
        rc = lib.gvdb_hash_features(
            concat, offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            len(blobs), self._seed_salt, len(self._seed_salt),
            lo_n, hi_n, self._buckets, m,
            sub_idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            sub_val.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        )
        if rc != 0:
            return False
        idx[ids] = sub_idx
        val[ids] = sub_val
        return True

    # -- device step -------------------------------------------------------------

    def _projection(self) -> torch.Tensor:
        """``jax.random.normal(PRNGKey(seed), (buckets, dim), bfloat16)`` on
        this embedder's device, built once per (buckets, dim, seed, device).
        bf16 is plenty for a random projection whose output is normalized,
        and halves the plane's bytes."""
        key = (self._buckets, self._dim, self._seed, str(self.device))
        hit = _PROJ_CACHE.get(key)
        if hit is not None:
            return hit
        with _PROJ_LOCK:
            hit = _PROJ_CACHE.get(key)
            if hit is None:
                hit = normal_bf16(self._seed, (self._buckets, self._dim)).to(self.device)
                _PROJ_CACHE[key] = hit
            return hit

    def _embed_chunk(self, idx: np.ndarray, val: np.ndarray,
                     proj: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """One chunk's device step: (f32 rows, their f16 copy), on the
        device. A bucket takes at most two adds in a row (+b and -(b+1)) and
        pad entries add 0 at bucket 0, so the accumulation is exact in any
        order."""
        idx_t = torch.from_numpy(idx).to(self.device).long()
        val_t = torch.from_numpy(val).to(self.device)
        rows = torch.arange(idx_t.shape[0], device=self.device)[:, None].expand_as(idx_t)
        plane = torch.zeros((idx_t.shape[0], self._buckets), dtype=torch.float32,
                            device=self.device)
        plane.index_put_((rows, idx_t), val_t, accumulate=True)
        # the plane's bf16 cast times the projection, f32 out (TF32 off)
        e = f32_dots(plane, proj.T)
        n = torch.linalg.vector_norm(e, dim=1, keepdim=True)
        out = e / torch.clamp(n, min=1e-12)
        return out, out.to(torch.float16)
