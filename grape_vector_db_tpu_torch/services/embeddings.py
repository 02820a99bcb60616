"""Embedding providers (reference src/embeddings.rs).

- ``MockEmbeddingProvider``: deterministic byte-hash vectors, L2-normalized —
  the standard no-network test fixture (embeddings.rs:222-266). Reproduced
  bit-compatibly in spirit: same text always yields the same unit vector.
- ``OpenAICompatibleProvider``: HTTP JSON provider covering openai/azure/nvidia/
  huggingface/ollama-style endpoints (embeddings.rs:55-219) with bearer auth,
  batch chunking, and linear-backoff retry. Uses stdlib urllib so no extra
  dependency is required; network use is entirely optional.
"""

from __future__ import annotations

import hashlib
import json
import time
import urllib.request
from typing import Dict, List, Optional, Sequence

import numpy as np

from grape_vector_db_tpu_torch.config import EmbeddingConfig
from grape_vector_db_tpu_torch.errors import NetworkError

__all__ = ["EmbeddingProvider", "MockEmbeddingProvider", "OpenAICompatibleProvider",
           "create_provider"]


class EmbeddingProvider:
    """embeddings.rs:14-19 trait: generate_embedding(s) + dimension."""

    def dimension(self) -> int:
        raise NotImplementedError

    def generate_embedding(self, text: str) -> List[float]:
        return self.generate_embeddings([text])[0]

    def generate_embeddings(self, texts: Sequence[str]) -> List[List[float]]:
        raise NotImplementedError


class MockEmbeddingProvider(EmbeddingProvider):
    """Deterministic hash-seeded unit vectors (embeddings.rs:222-266)."""

    def __init__(self, dim: int = 768):
        self._dim = dim

    def dimension(self) -> int:
        return self._dim

    def generate_embeddings(self, texts: Sequence[str]) -> List[List[float]]:
        return [self._embed(t) for t in texts]

    def embed_array(self, texts: Sequence[str]) -> np.ndarray:
        return np.stack([np.asarray(self._embed(t), dtype=np.float32) for t in texts])

    def _embed(self, text: str) -> List[float]:
        # Hash -> seed -> gaussian -> L2 normalize. Deterministic across runs
        # and processes (unlike Python's hash()).
        seed = int.from_bytes(hashlib.sha256(text.encode("utf-8")).digest()[:8], "little")
        rng = np.random.default_rng(seed)
        v = rng.standard_normal(self._dim).astype(np.float32)
        n = float(np.linalg.norm(v))
        if n > 0:
            v /= n
        return v.tolist()


class OpenAICompatibleProvider(EmbeddingProvider):
    """OpenAI-compatible /v1/embeddings provider (embeddings.rs:55-219)."""

    def __init__(self, config: EmbeddingConfig):
        if not config.endpoint:
            raise ValueError("OpenAICompatibleProvider requires an endpoint")
        self.config = config

    def dimension(self) -> int:
        return self.config.dimension

    def generate_embeddings(self, texts: Sequence[str]) -> List[List[float]]:
        out: List[List[float]] = []
        bs = max(1, self.config.batch_size)
        for i in range(0, len(texts), bs):
            out.extend(self._call(list(texts[i:i + bs])))
        return out

    def _call(self, batch: List[str]) -> List[List[float]]:
        body = json.dumps({"model": self.config.model, "input": batch}).encode()
        headers: Dict[str, str] = {"Content-Type": "application/json"}
        if self.config.api_key:
            if self.config.provider == "azure":
                # Azure OpenAI authenticates with the api-key header
                headers["api-key"] = self.config.api_key
            else:
                headers["Authorization"] = f"Bearer {self.config.api_key}"
        headers.update(self.config.extra_headers)
        url = self.config.endpoint.rstrip("/")
        if not url.endswith("/embeddings"):
            url += "/embeddings"
        if self.config.api_version:
            sep = "&" if "?" in url else "?"
            url += f"{sep}api-version={self.config.api_version}"
        last_err: Optional[Exception] = None
        for attempt in range(self.config.max_retries + 1):
            try:
                req = urllib.request.Request(url, data=body, headers=headers)
                with urllib.request.urlopen(req, timeout=self.config.timeout_s) as resp:
                    data = json.loads(resp.read().decode("utf-8"))
                items = sorted(data["data"], key=lambda d: d.get("index", 0))
                return [d["embedding"] for d in items]
            except Exception as e:  # linear backoff retry (embeddings.rs retry loop)
                last_err = e
                time.sleep(0.5 * (attempt + 1))
        raise NetworkError(f"embedding request failed after retries: {last_err}")


def create_provider(config: EmbeddingConfig, device="cuda") -> EmbeddingProvider:
    """Factory (embeddings.rs:269-286): openai/azure/nvidia/huggingface/ollama all
    speak the OpenAI-compatible shape; 'mock' is the offline fixture; 'device'
    is the local embedder (signed feature hashing + a projection on
    ``device`` — similar texts get similar vectors, no network)."""
    if config.provider == "mock":
        return MockEmbeddingProvider(config.dimension)
    if config.provider == "device":
        from grape_vector_db_tpu_torch.services.device_embedder import DeviceHashEmbedder

        return DeviceHashEmbedder(
            dim=config.dimension, buckets=config.hash_buckets,
            seed=config.hash_seed, max_features=config.hash_max_features,
            device=device,
        )
    return OpenAICompatibleProvider(config)
