"""gRPC service — the single-node server mode.

Implements the reference's ``VectorDbService`` wire surface (grpc/server.rs:
23-627; proto/vector_db.proto:6-38): 20 RPCs across vector ops, document ops,
cluster, Raft, shard, and monitoring groups. Unlike the reference — whose
cluster/Raft/shard handlers return hardcoded success stubs
(grpc/server.rs:456-605) — the cluster-facing handlers here delegate to an
attached cluster node when one is present and return real single-node answers
otherwise.

grpcio-tools isn't available in this image, so service registration is done
with ``grpc.method_handlers_generic_handler`` over protoc-generated message
classes — same wire format, no plugin codegen.
"""

from __future__ import annotations

import json
import threading
import time
from concurrent import futures
from typing import Any, Callable, Dict, List, Optional

import grpc
import numpy as np

from grape_vector_db_tpu_torch.db import VectorDatabase
from grape_vector_db_tpu_torch.engine.filtering import parse_sql_where
from grape_vector_db_tpu_torch.server.proto import vector_db_pb2 as pb
from grape_vector_db_tpu_torch.types import (
    Document,
    FusionStrategy,
    HybridSearchRequest,
    SearchRequest,
)

__all__ = ["SERVICE_NAME", "VectorDbServicer", "build_grpc_server", "VectorDbClient"]

SERVICE_NAME = "grape.vectordb.VectorDbService"

# (method, request type, response type) — the full 20-RPC surface.
_METHODS = [
    ("UpsertVector", pb.UpsertVectorRequest, pb.UpsertVectorResponse),
    ("DeleteVector", pb.DeleteVectorRequest, pb.DeleteVectorResponse),
    ("SearchVectors", pb.SearchVectorsRequest, pb.SearchVectorsResponse),
    ("GetVector", pb.GetVectorRequest, pb.GetVectorResponse),
    ("AddDocument", pb.AddDocumentRequest, pb.AddDocumentResponse),
    ("GetDocument", pb.GetDocumentRequest, pb.GetDocumentResponse),
    ("SearchDocuments", pb.SearchDocumentsRequest, pb.SearchDocumentsResponse),
    ("DeleteDocument", pb.DeleteDocumentRequest, pb.DeleteDocumentResponse),
    ("JoinCluster", pb.JoinClusterRequest, pb.JoinClusterResponse),
    ("LeaveCluster", pb.LeaveClusterRequest, pb.LeaveClusterResponse),
    ("GetClusterInfo", pb.GetClusterInfoRequest, pb.GetClusterInfoResponse),
    ("Heartbeat", pb.HeartbeatRequest, pb.HeartbeatResponse),
    ("AppendEntries", pb.AppendEntriesRequest, pb.AppendEntriesResponse),
    ("RequestVote", pb.RequestVoteRequest, pb.RequestVoteResponse),
    ("InstallSnapshot", pb.InstallSnapshotRequest, pb.InstallSnapshotResponse),
    ("MigrateShard", pb.MigrateShardRequest, pb.MigrateShardResponse),
    ("RebalanceShards", pb.RebalanceShardsRequest, pb.RebalanceShardsResponse),
    ("GetShardInfo", pb.GetShardInfoRequest, pb.GetShardInfoResponse),
    ("GetStats", pb.GetStatsRequest, pb.GetStatsResponse),
    ("GetMetrics", pb.GetMetricsRequest, pb.GetMetricsResponse),
    ("Internal", pb.InternalRequest, pb.InternalResponse),
]


def _payload_to_str_map(meta: Dict[str, Any]) -> Dict[str, str]:
    return {k: v if isinstance(v, str) else json.dumps(v) for k, v in (meta or {}).items()}


def _str_map_to_payload(m) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for k, v in dict(m).items():
        try:
            out[k] = json.loads(v)
        except (json.JSONDecodeError, TypeError):
            out[k] = v
    return out


class VectorDbServicer:
    """RPC handlers over a VectorDatabase (+ optional cluster node)."""

    def __init__(self, db: VectorDatabase, node: Optional[Any] = None,
                 node_id: str = "standalone", started_at: Optional[float] = None,
                 use_batcher: bool = True, cluster_node: Optional[Any] = None):
        self.db = db
        self.node = node  # GrpcClusterAdapter when in cluster mode
        # The raw ClusterNode: when present, data RPCs route through the
        # cluster (shard-routed replicated writes, scatter-gather reads)
        # instead of the local db only.
        self.cluster_node = cluster_node
        self.node_id = node_id
        self._t0 = started_at or time.time()
        # Micro-batching executor: concurrent unfiltered SearchVectors calls
        # share one device batch (services/concurrent.py).
        self.batcher = None
        if use_batcher:
            from grape_vector_db_tpu_torch.services.concurrent import BatchingExecutor

            # no padding to one batch size (pad_to=None): eager PyTorch
            # compiles no shapes, and the segment kernels take any batch up
            # to their cap
            self.batcher = BatchingExecutor(
                db.engine.vector_search_batch,
                max_batch=db.config.device.max_query_batch,
                max_wait_ms=db.config.device.micro_batch_wait_ms,
            )

    def _authorize(self, ctx, perm) -> Optional[str]:
        """API-key auth from gRPC metadata when enterprise is enabled
        (lib.rs:717-787 gRPC-facing enforcement). Returns an error string for
        in-band reporting, or None when authorized."""
        if self.db.auth is None:
            return None
        meta = dict(ctx.invocation_metadata()) if ctx is not None else {}
        cred = meta.get("x-api-key", "")
        try:
            self.db.auth.authorize(cred, perm)
            return None
        except Exception as e:
            return f"unauthorized: {e}"

    # -- vector ops ------------------------------------------------------------

    def UpsertVector(self, req, ctx):
        from grape_vector_db_tpu_torch.services.enterprise import Permission

        err = self._authorize(ctx, Permission.WRITE_DATA)
        if err:
            return pb.UpsertVectorResponse(error=err)
        try:
            docs = [
                Document(
                    id=p.id,
                    content="",
                    vector=list(p.vector.values),
                    metadata=_str_map_to_payload(p.payload),
                )
                for p in req.points
            ]
            if self.cluster_node is not None:
                from grape_vector_db_tpu_torch.distributed.types import SessionToken

                token = SessionToken()
                n = self.cluster_node.upsert(docs, session=token)
                return pb.UpsertVectorResponse(
                    upserted=n, session_versions=token.to_dict()
                )
            ids = self.db.batch_add_documents(docs)
            return pb.UpsertVectorResponse(upserted=len(ids))
        except Exception as e:
            return pb.UpsertVectorResponse(error=str(e))

    def DeleteVector(self, req, ctx):
        from grape_vector_db_tpu_torch.services.enterprise import Permission

        err = self._authorize(ctx, Permission.WRITE_DATA)
        if err:
            return pb.DeleteVectorResponse(error=err)
        try:
            if self.cluster_node is not None:
                from grape_vector_db_tpu_torch.distributed.types import SessionToken

                token = SessionToken()
                n = self.cluster_node.delete(list(req.ids), session=token)
                return pb.DeleteVectorResponse(
                    deleted=n, session_versions=token.to_dict()
                )
            n = self.db.batch_delete_documents(list(req.ids))
            return pb.DeleteVectorResponse(deleted=n)
        except Exception as e:
            return pb.DeleteVectorResponse(error=str(e))

    def SearchVectors(self, req, ctx):
        from grape_vector_db_tpu_torch.services.enterprise import Permission

        err = self._authorize(ctx, Permission.READ_DATA)
        if err:
            return pb.SearchVectorsResponse(error=err)
        try:
            if self.cluster_node is not None and not req.filter_sql:
                session = None
                if req.min_versions:
                    from grape_vector_db_tpu_torch.distributed.types import SessionToken

                    session = SessionToken.from_dict(dict(req.min_versions))
                stale: list = []
                hits = self.cluster_node.search(
                    list(req.query.values), k=int(req.limit) or 10,
                    session=session, stale_out=stale,
                )
                return pb.SearchVectorsResponse(
                    results=[pb.SearchResult(id=i, score=s) for i, s in hits],
                    stale_shards=sorted(set(stale)),
                )
            # Fast path: unfiltered searches ride the micro-batching executor
            # so concurrent RPCs share one device launch (ef requests skip it —
            # the batcher packs requests that share one kernel configuration).
            if (self.batcher is not None and not req.filter_sql
                    and not req.score_threshold and not req.with_payload
                    and not req.ef and not req.host_rescore):
                import numpy as np

                hits = self.batcher.search(
                    np.asarray(list(req.query.values), dtype=np.float32),
                    int(req.limit) or 10,
                )
                return pb.SearchVectorsResponse(
                    results=[pb.SearchResult(id=h.id, score=h.score) for h in hits]
                )
            params = None
            if req.ef or req.host_rescore:
                from grape_vector_db_tpu_torch.types import SearchParams

                params = SearchParams(
                    ef=int(req.ef) or None,
                    host_rescore=int(req.host_rescore) or None,
                    with_payload=req.with_payload)
            sreq = SearchRequest(
                vector=list(req.query.values),
                limit=int(req.limit) or 10,
                score_threshold=req.score_threshold if req.score_threshold else None,
                filter=parse_sql_where(req.filter_sql) if req.filter_sql else None,
                with_payload=req.with_payload,
                params=params,
            )
            hits = self.db.vector_search(sreq)
            return pb.SearchVectorsResponse(
                results=[
                    pb.SearchResult(
                        id=h.id, score=h.score,
                        payload=_payload_to_str_map(h.payload if req.with_payload else {}),
                    )
                    for h in hits
                ]
            )
        except Exception as e:
            return pb.SearchVectorsResponse(error=str(e))

    def GetVector(self, req, ctx):
        doc = self.db.get_document(req.id)
        if doc is None or doc.vector is None:
            return pb.GetVectorResponse(found=False)
        return pb.GetVectorResponse(
            found=True,
            point=pb.Point(
                id=doc.id,
                vector=pb.Vector(values=doc.vector),
                payload=_payload_to_str_map(doc.metadata),
            ),
        )

    # -- document ops -------------------------------------------------------------

    def AddDocument(self, req, ctx):
        try:
            docs = [
                Document(
                    id=d.id,
                    title=d.title or None,
                    content=d.content,
                    language=d.language or None,
                    doc_type=d.doc_type or None,
                    vector=list(d.vector) if d.vector else None,  # proto repeated: empty = absent
                    metadata=_str_map_to_payload(d.metadata),
                )
                for d in req.documents
            ]
            ids = self.db.batch_add_documents(docs)
            return pb.AddDocumentResponse(ids=ids)
        except Exception as e:
            return pb.AddDocumentResponse(error=str(e))

    def GetDocument(self, req, ctx):
        doc = self.db.get_document(req.id)
        if doc is None:
            return pb.GetDocumentResponse(found=False)
        return pb.GetDocumentResponse(
            found=True,
            document=pb.Document(
                id=doc.id, title=doc.title or "", content=doc.content,
                language=doc.language or "", doc_type=doc.doc_type or "",
                vector=list(doc.vector) if doc.vector is not None else [],
                metadata=_payload_to_str_map(doc.metadata),
            ),
        )

    def SearchDocuments(self, req, ctx):
        try:
            limit = int(req.limit) or 10
            filt = parse_sql_where(req.filter_sql) if req.filter_sql else None
            mode = req.mode or "semantic"
            if mode == "text":
                results = self.db.text_search(SearchRequest(query=req.query, limit=limit,
                                                            filter=filt))
            elif mode == "hybrid":
                results = self.db.hybrid_search(
                    HybridSearchRequest(
                        query=req.query, limit=limit, filter=filt,
                        fusion_strategy=FusionStrategy(req.fusion or "rrf"),
                    )
                )
            else:
                results = self.db.search_documents(req.query, limit)
                if filt is not None:
                    allowed = set(self.db.filter_engine.execute_filter(filt))
                    results = [r for r in results if r.document.id in allowed]
            return pb.SearchDocumentsResponse(
                results=[
                    pb.SearchResult(
                        id=r.document.id, score=r.score, snippet=r.snippet or "",
                        payload=_payload_to_str_map(r.document.metadata),
                    )
                    for r in results
                ]
            )
        except Exception as e:
            return pb.SearchDocumentsResponse(error=str(e))

    def DeleteDocument(self, req, ctx):
        try:
            n = self.db.batch_delete_documents(list(req.ids))
            return pb.DeleteDocumentResponse(deleted=n)
        except Exception as e:
            return pb.DeleteDocumentResponse(error=str(e))

    # -- cluster group (delegates to the node when clustered) ------------------------

    def JoinCluster(self, req, ctx):
        if self.node is not None:
            return self.node.handle_join(req)
        return pb.JoinClusterResponse(accepted=False, error="not running in cluster mode")

    def LeaveCluster(self, req, ctx):
        if self.node is not None:
            return self.node.handle_leave(req)
        return pb.LeaveClusterResponse(ok=False)

    def GetClusterInfo(self, req, ctx):
        if self.node is not None:
            return self.node.handle_cluster_info(req)
        return pb.GetClusterInfoResponse(
            cluster_id="standalone",
            leader_id=self.node_id,
            shard_count=1,
            members=[pb.NodeInfo(node_id=self.node_id, address="local", state="healthy")],
        )

    def Heartbeat(self, req, ctx):
        if self.node is not None:
            return self.node.handle_heartbeat(req)
        return pb.HeartbeatResponse(ok=True, term=0)

    # -- raft group -------------------------------------------------------------------

    def AppendEntries(self, req, ctx):
        if self.node is not None:
            return self.node.handle_append_entries(req)
        return pb.AppendEntriesResponse(term=0, success=False)

    def RequestVote(self, req, ctx):
        if self.node is not None:
            return self.node.handle_request_vote(req)
        return pb.RequestVoteResponse(term=0, vote_granted=False)

    def InstallSnapshot(self, req, ctx):
        if self.node is not None:
            return self.node.handle_install_snapshot(req)
        return pb.InstallSnapshotResponse(term=0, ok=False)

    # -- shard group -------------------------------------------------------------------

    def MigrateShard(self, req, ctx):
        if self.node is not None:
            return self.node.handle_migrate_shard(req)
        return pb.MigrateShardResponse(ok=False, error="not running in cluster mode")

    def RebalanceShards(self, req, ctx):
        if self.node is not None:
            return self.node.handle_rebalance(req)
        return pb.RebalanceShardsResponse(ok=True, moves=0)

    def GetShardInfo(self, req, ctx):
        if self.node is not None:
            return self.node.handle_shard_info(req)
        return pb.GetShardInfoResponse(
            shard_id=req.shard_id, primary_node=self.node_id,
            point_count=self.db.stats().index_size, state="active",
        )

    # -- monitoring --------------------------------------------------------------------

    def GetStats(self, req, ctx):
        s = self.db.stats()
        return pb.GetStatsResponse(
            document_count=s.document_count,
            index_size=s.index_size,
            storage_bytes=float(s.storage_size_bytes),
            index_kind=s.index_kind,
            uptime_s=time.time() - self._t0,
        )

    def GetMetrics(self, req, ctx):
        return pb.GetMetricsResponse(prometheus_text=self.db.metrics.prometheus_text())

    def Internal(self, req, ctx):
        """Generic node-to-node transport carrier (see cluster_adapter)."""
        if self.node is not None and hasattr(self.node, "handle_internal"):
            return self.node.handle_internal(req)
        return pb.InternalResponse(error="not running in cluster mode")


def server_credentials(tls) -> "grpc.ServerCredentials":
    """grpc.ssl_server_credentials from a TlsConfig (enterprise.rs:786 tls,
    actually enforced here)."""
    with open(tls.key_path, "rb") as f:
        key = f.read()
    with open(tls.cert_path, "rb") as f:
        cert = f.read()
    root = None
    if tls.ca_path:
        with open(tls.ca_path, "rb") as f:
            root = f.read()
    if tls.require_client_auth and root is None:
        # fail fast: a config that demands mutual auth must not silently
        # degrade to server-only TLS
        raise ValueError(
            "TlsConfig.require_client_auth=True needs ca_path — refusing to "
            "silently serve without client auth")
    return grpc.ssl_server_credentials(
        [(key, cert)],
        root_certificates=root,
        require_client_auth=bool(tls.require_client_auth),
    )


def channel_credentials(tls) -> "grpc.ChannelCredentials":
    root = None
    if tls.ca_path:
        with open(tls.ca_path, "rb") as f:
            root = f.read()
    key = cert = None
    if tls.require_client_auth and tls.key_path and tls.cert_path:
        with open(tls.key_path, "rb") as f:
            key = f.read()
        with open(tls.cert_path, "rb") as f:
            cert = f.read()
    return grpc.ssl_channel_credentials(
        root_certificates=root, private_key=key, certificate_chain=cert
    )


def secure_channel(address: str, tls) -> "grpc.Channel":
    opts = []
    if tls.target_name_override:
        opts.append(("grpc.ssl_target_name_override", tls.target_name_override))
    return grpc.secure_channel(address, channel_credentials(tls), options=opts)


def build_grpc_server(
    db: VectorDatabase,
    port: int = 0,
    node: Optional[Any] = None,
    node_id: str = "standalone",
    max_workers: int = 16,
    use_batcher: bool = True,
    cluster_node: Optional[Any] = None,
    tls=None,
):
    """Create (server, bound_port). Caller starts/stops the server.
    With ``tls`` (an enabled TlsConfig) the port is TLS-terminated; with
    ``require_client_auth`` + ``ca_path`` it enforces mTLS."""
    servicer = VectorDbServicer(db, node=node, node_id=node_id,
                                use_batcher=use_batcher,
                                cluster_node=cluster_node)
    handlers = {}
    for name, req_t, resp_t in _METHODS:
        fn = getattr(servicer, name)
        handlers[name] = grpc.unary_unary_rpc_method_handler(
            fn,
            request_deserializer=req_t.FromString,
            response_serializer=resp_t.SerializeToString,
        )
    server = grpc.server(futures.ThreadPoolExecutor(max_workers=max_workers))
    server.add_generic_rpc_handlers(
        (grpc.method_handlers_generic_handler(SERVICE_NAME, handlers),)
    )
    if tls is not None and tls.enabled:
        bound = server.add_secure_port(f"[::]:{port}", server_credentials(tls))
    else:
        bound = server.add_insecure_port(f"[::]:{port}")
    return server, bound, servicer


class VectorDbClient:
    """Thin typed client (reference grpc/client.rs:11-119)."""

    def __init__(self, address: str, timeout_s: float = 10.0, tls=None):
        if tls is not None and tls.enabled:
            self.channel = secure_channel(address, tls)
        else:
            self.channel = grpc.insecure_channel(address)
        self.timeout_s = timeout_s
        self._stubs: Dict[str, Callable] = {}
        for name, req_t, resp_t in _METHODS:
            self._stubs[name] = self.channel.unary_unary(
                f"/{SERVICE_NAME}/{name}",
                request_serializer=req_t.SerializeToString,
                response_deserializer=resp_t.FromString,
            )

    def call(self, method: str, request, timeout_s: Optional[float] = None):
        return self._stubs[method](request, timeout=timeout_s or self.timeout_s)

    def __getattr__(self, name: str):
        if name in self._stubs:
            return lambda req, **kw: self.call(name, req, **kw)
        raise AttributeError(name)

    # convenience wrappers ---------------------------------------------------------

    def upsert_points(self, points: List[pb.Point]) -> pb.UpsertVectorResponse:
        return self.call("UpsertVector", pb.UpsertVectorRequest(points=points))

    def search(self, vector: List[float], limit: int = 10,
               filter_sql: str = "", with_payload: bool = True,
               min_versions: Optional[Dict[str, int]] = None,
               ef: int = 0, host_rescore: int = 0,
               ) -> pb.SearchVectorsResponse:
        """``min_versions``: feed back ``session_versions`` from an earlier
        upsert/delete response for read-your-writes (SESSION consistency).
        ``ef``: per-request precision dial (IVF nprobe override; 0 = default).
        ``host_rescore``: host-tier exact rescore width over the store's
        full-precision embeddings (0 = server config default)."""
        return self.call(
            "SearchVectors",
            pb.SearchVectorsRequest(
                query=pb.Vector(values=vector), limit=limit,
                filter_sql=filter_sql, with_payload=with_payload,
                min_versions=min_versions or {},
                ef=ef, host_rescore=host_rescore,
            ),
        )

    def close(self) -> None:
        self.channel.close()
