"""REST/JSON server — the HTTP surface of the single-node server.

The reference's HTTP side was client-only: `network_client.rs` calls
``/api/v1/{heartbeat,replicate,vectors,vectors/{id},search,shards/migrate,
health,documents,documents/batch}`` and `network.rs` calls ``/raft/*`` and
``/cluster/*``, but the server is a logging stub that binds nothing
(network.rs:447-502). This module implements those endpoints for real over
stdlib http.server (threaded), so the inter-node surface actually answers.

Also serves `/metrics` (Prometheus text, same ``grape_vector_db_*`` names) and
`/health`.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional, Tuple
from urllib.parse import urlparse

from grape_vector_db_tpu_torch.db import VectorDatabase
from grape_vector_db_tpu_torch.engine.filtering import parse_sql_where
from grape_vector_db_tpu_torch.types import Document, HybridSearchRequest, SearchRequest

__all__ = ["RestServer"]


class RestServer:
    """Threaded REST server over a VectorDatabase (+ optional cluster node)."""

    def __init__(self, db: VectorDatabase, host: str = "127.0.0.1", port: int = 0,
                 node: Optional[Any] = None, tls=None):
        self.db = db
        self.node = node
        self.tls = tls
        outer = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):  # quiet
                pass

            def _json(self, code: int, obj: Any) -> None:
                body = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _text(self, code: int, text: str, ctype="text/plain") -> None:
                body = text.encode()
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _body(self) -> Dict[str, Any]:
                n = int(self.headers.get("Content-Length", 0))
                if n == 0:
                    return {}
                return json.loads(self.rfile.read(n) or b"{}")

            # -- GET ---------------------------------------------------------

            def do_GET(self):
                path = urlparse(self.path).path
                try:
                    if path == "/health" or path == "/api/v1/health":
                        h = outer.db.health_check()
                        self._json(200 if h["status"] == "healthy" else 503, h)
                    elif path == "/metrics":
                        self._text(200, outer.db.metrics.prometheus_text())
                    elif path == "/api/v1/stats":
                        s = outer.db.stats()
                        self._json(200, {
                            "document_count": s.document_count,
                            "index_size": s.index_size,
                            "index_kind": s.index_kind,
                            "storage_size_bytes": s.storage_size_bytes,
                            "uptime_s": s.uptime_s,
                        })
                    elif path.startswith("/api/v1/vectors/"):
                        id_ = path.rsplit("/", 1)[1]
                        doc = outer.db.get_document(id_)
                        if doc is None:
                            self._json(404, {"error": "not found"})
                        else:
                            self._json(200, {"id": doc.id, "vector": doc.vector,
                                             "metadata": doc.metadata})
                    elif path.startswith("/api/v1/documents/"):
                        id_ = path.rsplit("/", 1)[1]
                        doc = outer.db.get_document(id_)
                        if doc is None:
                            self._json(404, {"error": "not found"})
                        else:
                            # an embedder-made or store-decoded vector is an
                            # ndarray, which json refuses (ROADMAP C.4)
                            body = doc.to_dict()
                            if hasattr(body["vector"], "tolist"):
                                body["vector"] = body["vector"].tolist()
                            self._json(200, body)
                    elif path == "/cluster/info":
                        if outer.node is not None:
                            self._json(200, outer.node.cluster_info_dict())
                        else:
                            self._json(200, {"cluster_id": "standalone", "members": []})
                    else:
                        self._json(404, {"error": f"no route {path}"})
                except Exception as e:
                    self._json(500, {"error": str(e)})

            # -- POST ---------------------------------------------------------

            def do_POST(self):
                path = urlparse(self.path).path
                try:
                    body = self._body()
                    if path == "/api/v1/vectors":
                        docs = [
                            Document(id=p["id"], content=p.get("content", ""),
                                     vector=p["vector"], metadata=p.get("metadata", {}))
                            for p in body.get("points", [body] if "id" in body else [])
                        ]
                        if outer.node is not None:
                            # Cluster mode: shard-routed replicated write;
                            # session_versions feed back into search
                            # min_versions for read-your-writes.
                            from grape_vector_db_tpu_torch.distributed.types import (
                                SessionToken,
                            )

                            session = SessionToken()
                            n = outer.node.upsert(docs, session=session)
                            self._json(200, {
                                "upserted": n, "ids": [d.id for d in docs],
                                "session_versions": session.to_dict(),
                            })
                        else:
                            ids = outer.db.batch_add_documents(docs)
                            self._json(200, {"upserted": len(ids), "ids": ids})
                    elif path == "/api/v1/documents":
                        doc = Document.from_dict(body)
                        outer.db.add_document(doc)
                        self._json(200, {"id": doc.id})
                    elif path == "/api/v1/documents/batch":
                        docs = [Document.from_dict(d) for d in body.get("documents", [])]
                        ids = outer.db.batch_add_documents(docs)
                        self._json(200, {"ids": ids})
                    elif path == "/api/v1/search":
                        self._handle_search(body)
                    elif path == "/api/v1/heartbeat":
                        if outer.node is not None:
                            self._json(200, outer.node.handle_heartbeat_dict(body))
                        else:
                            self._json(200, {"ok": True})
                    elif path == "/api/v1/replicate":
                        if outer.node is not None:
                            self._json(200, outer.node.handle_replicate_dict(body))
                        else:
                            self._json(400, {"error": "not in cluster mode"})
                    elif path == "/api/v1/shards/migrate":
                        if outer.node is not None:
                            self._json(200, outer.node.handle_migrate_dict(body))
                        else:
                            self._json(400, {"error": "not in cluster mode"})
                    elif path.startswith("/raft/") or path.startswith("/cluster/"):
                        if outer.node is not None:
                            self._json(200, outer.node.handle_http(path, body))
                        else:
                            self._json(400, {"error": "not in cluster mode"})
                    else:
                        self._json(404, {"error": f"no route {path}"})
                except Exception as e:
                    self._json(500, {"error": str(e)})

            def _handle_search(self, body: Dict[str, Any]) -> None:
                mode = body.get("mode", "vector")
                limit = int(body.get("limit", 10))
                filt = parse_sql_where(body["filter_sql"]) if body.get("filter_sql") else None
                if mode == "vector":
                    # Cluster path with SESSION read-your-writes: feed back
                    # the session_versions of an earlier write as
                    # min_versions (parity with the gRPC surface).
                    if outer.node is not None and filt is None:
                        from grape_vector_db_tpu_torch.distributed.types import (
                            SessionToken,
                        )

                        session = None
                        if body.get("min_versions"):
                            session = SessionToken.from_dict(
                                {str(k): int(v)
                                 for k, v in body["min_versions"].items()})
                        stale: list = []
                        hits = outer.node.search(
                            body["vector"], k=limit, session=session,
                            stale_out=stale,
                        )
                        thr = body.get("score_threshold")
                        if thr is not None:
                            hits = [(i, sc) for i, sc in hits if sc >= thr]
                        results = [{"id": i, "score": sc} for i, sc in hits]
                        if body.get("with_payload", True):
                            docs = outer.node.get_documents(
                                [i for i, _ in hits])
                            for r in results:
                                d = docs.get(r["id"])
                                r["payload"] = d.metadata if d else None
                        self._json(200, {
                            "results": results,
                            "stale_shards": sorted(set(stale)),
                        })
                        return
                    params = None
                    # explicit host_rescore=0 disables the host tier for this
                    # request (None / absent = server config default)
                    if body.get("ef") or "host_rescore" in body:
                        from grape_vector_db_tpu_torch.types import SearchParams

                        params = SearchParams(
                            ef=int(body.get("ef") or 0) or None,
                            host_rescore=(int(body["host_rescore"])
                                          if "host_rescore" in body else None),
                            with_payload=body.get("with_payload", True),
                        )
                    req = SearchRequest(
                        vector=body["vector"], limit=limit, filter=filt,
                        score_threshold=body.get("score_threshold"),
                        with_payload=body.get("with_payload", True),
                        params=params,
                    )
                    hits = outer.db.vector_search(req)
                    self._json(200, {"results": [
                        {"id": h.id, "score": h.score, "payload": h.payload}
                        for h in hits
                    ]})
                elif mode == "text":
                    res = outer.db.text_search(
                        SearchRequest(query=body.get("query", ""), limit=limit, filter=filt)
                    )
                    self._json(200, {"results": [
                        {"id": r.document.id, "score": r.score, "snippet": r.snippet}
                        for r in res
                    ]})
                else:  # hybrid / semantic
                    res = outer.db.hybrid_search(HybridSearchRequest(
                        query=body.get("query", ""), limit=limit, filter=filt,
                    ))
                    self._json(200, {"results": [
                        {"id": r.document.id, "score": r.score, "snippet": r.snippet}
                        for r in res
                    ]})

            # -- DELETE --------------------------------------------------------

            def do_DELETE(self):
                path = urlparse(self.path).path
                try:
                    if path.startswith("/api/v1/vectors/") or path.startswith("/api/v1/documents/"):
                        id_ = path.rsplit("/", 1)[1]
                        if outer.node is not None:
                            # cluster mode: the doc lives on its shard's
                            # owners, which may not include this node — a
                            # local-only delete would be a silent no-op.
                            # STRONG delete() can't report a count (the
                            # command commits regardless of existence), so
                            # resolve the status code with a point lookup
                            # first — local mode 404s on unknown ids and the
                            # two deployments must answer alike.
                            if outer.node.get_documents([id_]):
                                n = outer.node.delete([id_])
                            else:
                                n = 0
                        else:
                            n = outer.db.batch_delete_documents([id_])
                        self._json(200 if n else 404, {"deleted": n})
                    else:
                        self._json(404, {"error": f"no route {path}"})
                except Exception as e:
                    self._json(500, {"error": str(e)})

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        if tls is not None and tls.enabled:
            import ssl

            ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
            ctx.load_cert_chain(tls.cert_path, tls.key_path)
            if tls.require_client_auth:
                if not tls.ca_path:
                    raise ValueError(
                        "TlsConfig.require_client_auth=True needs ca_path — "
                        "refusing to silently serve without client auth")
                ctx.load_verify_locations(tls.ca_path)
                ctx.verify_mode = ssl.CERT_REQUIRED
            self._httpd.socket = ctx.wrap_socket(self._httpd.socket,
                                                 server_side=True)
        self.host, self.port = self._httpd.server_address[:2]
        self._thread: Optional[threading.Thread] = None

    def start(self) -> Tuple[str, int]:
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True, name="gvdb-rest"
        )
        self._thread.start()
        return self.host, self.port

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread:
            self._thread.join(timeout=2.0)
