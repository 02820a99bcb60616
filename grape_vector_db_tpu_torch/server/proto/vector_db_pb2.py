# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: proto/vector_db.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x15proto/vector_db.proto\x12\x0egrape.vectordb\"D\n\x0fInternalRequest\x12\x10\n\x08src_node\x18\x01 \x01(\t\x12\x0e\n\x06method\x18\x02 \x01(\t\x12\x0f\n\x07payload\x18\x03 \x01(\x0c\"2\n\x10InternalResponse\x12\x0f\n\x07payload\x18\x01 \x01(\x0c\x12\r\n\x05\x65rror\x18\x02 \x01(\t\"\x18\n\x06Vector\x12\x0e\n\x06values\x18\x01 \x03(\x02\"\xa0\x01\n\x05Point\x12\n\n\x02id\x18\x01 \x01(\t\x12&\n\x06vector\x18\x02 \x01(\x0b\x32\x16.grape.vectordb.Vector\x12\x33\n\x07payload\x18\x03 \x03(\x0b\x32\".grape.vectordb.Point.PayloadEntry\x1a.\n\x0cPayloadEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\t:\x02\x38\x01\"\xd5\x01\n\x08\x44ocument\x12\n\n\x02id\x18\x01 \x01(\t\x12\r\n\x05title\x18\x02 \x01(\t\x12\x0f\n\x07\x63ontent\x18\x03 \x01(\t\x12\x10\n\x08language\x18\x04 \x01(\t\x12\x10\n\x08\x64oc_type\x18\x05 \x01(\t\x12\x0e\n\x06vector\x18\x06 \x03(\x02\x12\x38\n\x08metadata\x18\x07 \x03(\x0b\x32&.grape.vectordb.Document.MetadataEntry\x1a/\n\rMetadataEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\t:\x02\x38\x01\"\xa6\x01\n\x0cSearchResult\x12\n\n\x02id\x18\x01 \x01(\t\x12\r\n\x05score\x18\x02 \x01(\x02\x12:\n\x07payload\x18\x03 \x03(\x0b\x32).grape.vectordb.SearchResult.PayloadEntry\x12\x0f\n\x07snippet\x18\x04 \x01(\t\x1a.\n\x0cPayloadEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\t:\x02\x38\x01\"<\n\x13UpsertVectorRequest\x12%\n\x06points\x18\x01 \x03(\x0b\x32\x15.grape.vectordb.Point\"\xc4\x01\n\x14UpsertVectorResponse\x12\x10\n\x08upserted\x18\x01 \x01(\x04\x12\r\n\x05\x65rror\x18\x02 \x01(\t\x12S\n\x10session_versions\x18\x03 \x03(\x0b\x32\x39.grape.vectordb.UpsertVectorResponse.SessionVersionsEntry\x1a\x36\n\x14SessionVersionsEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\x04:\x02\x38\x01\"\"\n\x13\x44\x65leteVectorRequest\x12\x0b\n\x03ids\x18\x01 \x03(\t\"\xc3\x01\n\x14\x44\x65leteVectorResponse\x12\x0f\n\x07\x64\x65leted\x18\x01 \x01(\x04\x12\r\n\x05\x65rror\x18\x02 \x01(\t\x12S\n\x10session_versions\x18\x03 \x03(\x0b\x32\x39.grape.vectordb.DeleteVectorResponse.SessionVersionsEntry\x1a\x36\n\x14SessionVersionsEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\x04:\x02\x38\x01\"\xb2\x02\n\x14SearchVectorsRequest\x12%\n\x05query\x18\x01 \x01(\x0b\x32\x16.grape.vectordb.Vector\x12\r\n\x05limit\x18\x02 \x01(\r\x12\x17\n\x0fscore_threshold\x18\x03 \x01(\x02\x12\x12\n\nfilter_sql\x18\x04 \x01(\t\x12\x14\n\x0cwith_payload\x18\x05 \x01(\x08\x12K\n\x0cmin_versions\x18\x06 \x03(\x0b\x32\x35.grape.vectordb.SearchVectorsRequest.MinVersionsEntry\x12\n\n\x02\x65\x66\x18\x07 \x01(\r\x12\x14\n\x0chost_rescore\x18\x08 \x01(\r\x1a\x32\n\x10MinVersionsEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\x04:\x02\x38\x01\"k\n\x15SearchVectorsResponse\x12-\n\x07results\x18\x01 \x03(\x0b\x32\x1c.grape.vectordb.SearchResult\x12\r\n\x05\x65rror\x18\x02 \x01(\t\x12\x14\n\x0cstale_shards\x18\x03 \x03(\r\"\x1e\n\x10GetVectorRequest\x12\n\n\x02id\x18\x01 \x01(\t\"H\n\x11GetVectorResponse\x12$\n\x05point\x18\x01 \x01(\x0b\x32\x15.grape.vectordb.Point\x12\r\n\x05\x66ound\x18\x02 \x01(\x08\"A\n\x12\x41\x64\x64\x44ocumentRequest\x12+\n\tdocuments\x18\x01 \x03(\x0b\x32\x18.grape.vectordb.Document\"1\n\x13\x41\x64\x64\x44ocumentResponse\x12\x0b\n\x03ids\x18\x01 \x03(\t\x12\r\n\x05\x65rror\x18\x02 \x01(\t\" \n\x12GetDocumentRequest\x12\n\n\x02id\x18\x01 \x01(\t\"P\n\x13GetDocumentResponse\x12*\n\x08\x64ocument\x18\x01 \x01(\x0b\x32\x18.grape.vectordb.Document\x12\r\n\x05\x66ound\x18\x02 \x01(\x08\"h\n\x16SearchDocumentsRequest\x12\r\n\x05query\x18\x01 \x01(\t\x12\r\n\x05limit\x18\x02 \x01(\r\x12\x0c\n\x04mode\x18\x03 \x01(\t\x12\x0e\n\x06\x66usion\x18\x04 \x01(\t\x12\x12\n\nfilter_sql\x18\x05 \x01(\t\"W\n\x17SearchDocumentsResponse\x12-\n\x07results\x18\x01 \x03(\x0b\x32\x1c.grape.vectordb.SearchResult\x12\r\n\x05\x65rror\x18\x02 \x01(\t\"$\n\x15\x44\x65leteDocumentRequest\x12\x0b\n\x03ids\x18\x01 \x03(\t\"8\n\x16\x44\x65leteDocumentResponse\x12\x0f\n\x07\x64\x65leted\x18\x01 \x01(\x04\x12\r\n\x05\x65rror\x18\x02 \x01(\t\"\xa0\x01\n\x08NodeInfo\x12\x0f\n\x07node_id\x18\x01 \x01(\t\x12\x0f\n\x07\x61\x64\x64ress\x18\x02 \x01(\t\x12\r\n\x05state\x18\x03 \x01(\t\x12\x34\n\x06labels\x18\x04 \x03(\x0b\x32$.grape.vectordb.NodeInfo.LabelsEntry\x1a-\n\x0bLabelsEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\t:\x02\x38\x01\"<\n\x12JoinClusterRequest\x12&\n\x04node\x18\x01 \x01(\x0b\x32\x18.grape.vectordb.NodeInfo\"a\n\x13JoinClusterResponse\x12\x10\n\x08\x61\x63\x63\x65pted\x18\x01 \x01(\x08\x12)\n\x07members\x18\x02 \x03(\x0b\x32\x18.grape.vectordb.NodeInfo\x12\r\n\x05\x65rror\x18\x03 \x01(\t\"&\n\x13LeaveClusterRequest\x12\x0f\n\x07node_id\x18\x01 \x01(\t\"\"\n\x14LeaveClusterResponse\x12\n\n\x02ok\x18\x01 \x01(\x08\"\x17\n\x15GetClusterInfoRequest\"\x7f\n\x16GetClusterInfoResponse\x12\x12\n\ncluster_id\x18\x01 \x01(\t\x12)\n\x07members\x18\x02 \x03(\x0b\x32\x18.grape.vectordb.NodeInfo\x12\x11\n\tleader_id\x18\x03 \x01(\t\x12\x13\n\x0bshard_count\x18\x04 \x01(\r\"?\n\x10HeartbeatRequest\x12\x0f\n\x07node_id\x18\x01 \x01(\t\x12\x0c\n\x04term\x18\x02 \x01(\x04\x12\x0c\n\x04load\x18\x03 \x01(\x01\"-\n\x11HeartbeatResponse\x12\n\n\x02ok\x18\x01 \x01(\x08\x12\x0c\n\x04term\x18\x02 \x01(\x04\"I\n\x08LogEntry\x12\r\n\x05index\x18\x01 \x01(\x04\x12\x0c\n\x04term\x18\x02 \x01(\x04\x12\x12\n\nentry_type\x18\x03 \x01(\t\x12\x0c\n\x04\x64\x61ta\x18\x04 \x01(\x0c\"\xa8\x01\n\x14\x41ppendEntriesRequest\x12\x0c\n\x04term\x18\x01 \x01(\x04\x12\x11\n\tleader_id\x18\x02 \x01(\t\x12\x16\n\x0eprev_log_index\x18\x03 \x01(\x04\x12\x15\n\rprev_log_term\x18\x04 \x01(\x04\x12)\n\x07\x65ntries\x18\x05 \x03(\x0b\x32\x18.grape.vectordb.LogEntry\x12\x15\n\rleader_commit\x18\x06 \x01(\x04\"K\n\x15\x41ppendEntriesResponse\x12\x0c\n\x04term\x18\x01 \x01(\x04\x12\x0f\n\x07success\x18\x02 \x01(\x08\x12\x13\n\x0bmatch_index\x18\x03 \x01(\x04\"g\n\x12RequestVoteRequest\x12\x0c\n\x04term\x18\x01 \x01(\x04\x12\x14\n\x0c\x63\x61ndidate_id\x18\x02 \x01(\t\x12\x16\n\x0elast_log_index\x18\x03 \x01(\x04\x12\x15\n\rlast_log_term\x18\x04 \x01(\x04\"9\n\x13RequestVoteResponse\x12\x0c\n\x04term\x18\x01 \x01(\x04\x12\x14\n\x0cvote_granted\x18\x02 \x01(\x08\"\x80\x01\n\x16InstallSnapshotRequest\x12\x0c\n\x04term\x18\x01 \x01(\x04\x12\x11\n\tleader_id\x18\x02 \x01(\t\x12\x1b\n\x13last_included_index\x18\x03 \x01(\x04\x12\x1a\n\x12last_included_term\x18\x04 \x01(\x04\x12\x0c\n\x04\x64\x61ta\x18\x05 \x01(\x0c\"3\n\x17InstallSnapshotResponse\x12\x0c\n\x04term\x18\x01 \x01(\x04\x12\n\n\x02ok\x18\x02 \x01(\x08\"K\n\x13MigrateShardRequest\x12\x10\n\x08shard_id\x18\x01 \x01(\r\x12\x11\n\tfrom_node\x18\x02 \x01(\t\x12\x0f\n\x07to_node\x18\x03 \x01(\t\"1\n\x14MigrateShardResponse\x12\n\n\x02ok\x18\x01 \x01(\x08\x12\r\n\x05\x65rror\x18\x02 \x01(\t\"\x18\n\x16RebalanceShardsRequest\"4\n\x17RebalanceShardsResponse\x12\n\n\x02ok\x18\x01 \x01(\x08\x12\r\n\x05moves\x18\x02 \x01(\r\"\'\n\x13GetShardInfoRequest\x12\x10\n\x08shard_id\x18\x01 \x01(\r\"y\n\x14GetShardInfoResponse\x12\x10\n\x08shard_id\x18\x01 \x01(\r\x12\x14\n\x0cprimary_node\x18\x02 \x01(\t\x12\x15\n\rreplica_nodes\x18\x03 \x03(\t\x12\x13\n\x0bpoint_count\x18\x04 \x01(\x04\x12\r\n\x05state\x18\x05 \x01(\t\"\x11\n\x0fGetStatsRequest\"{\n\x10GetStatsResponse\x12\x16\n\x0e\x64ocument_count\x18\x01 \x01(\x04\x12\x12\n\nindex_size\x18\x02 \x01(\x04\x12\x15\n\rstorage_bytes\x18\x03 \x01(\x01\x12\x12\n\nindex_kind\x18\x04 \x01(\t\x12\x10\n\x08uptime_s\x18\x05 \x01(\x01\"\x13\n\x11GetMetricsRequest\"-\n\x12GetMetricsResponse\x12\x17\n\x0fprometheus_text\x18\x01 \x01(\t2\xf9\x0e\n\x0fVectorDbService\x12Y\n\x0cUpsertVector\x12#.grape.vectordb.UpsertVectorRequest\x1a$.grape.vectordb.UpsertVectorResponse\x12Y\n\x0c\x44\x65leteVector\x12#.grape.vectordb.DeleteVectorRequest\x1a$.grape.vectordb.DeleteVectorResponse\x12\\\n\rSearchVectors\x12$.grape.vectordb.SearchVectorsRequest\x1a%.grape.vectordb.SearchVectorsResponse\x12P\n\tGetVector\x12 .grape.vectordb.GetVectorRequest\x1a!.grape.vectordb.GetVectorResponse\x12V\n\x0b\x41\x64\x64\x44ocument\x12\".grape.vectordb.AddDocumentRequest\x1a#.grape.vectordb.AddDocumentResponse\x12V\n\x0bGetDocument\x12\".grape.vectordb.GetDocumentRequest\x1a#.grape.vectordb.GetDocumentResponse\x12\x62\n\x0fSearchDocuments\x12&.grape.vectordb.SearchDocumentsRequest\x1a\'.grape.vectordb.SearchDocumentsResponse\x12_\n\x0e\x44\x65leteDocument\x12%.grape.vectordb.DeleteDocumentRequest\x1a&.grape.vectordb.DeleteDocumentResponse\x12V\n\x0bJoinCluster\x12\".grape.vectordb.JoinClusterRequest\x1a#.grape.vectordb.JoinClusterResponse\x12Y\n\x0cLeaveCluster\x12#.grape.vectordb.LeaveClusterRequest\x1a$.grape.vectordb.LeaveClusterResponse\x12_\n\x0eGetClusterInfo\x12%.grape.vectordb.GetClusterInfoRequest\x1a&.grape.vectordb.GetClusterInfoResponse\x12P\n\tHeartbeat\x12 .grape.vectordb.HeartbeatRequest\x1a!.grape.vectordb.HeartbeatResponse\x12\\\n\rAppendEntries\x12$.grape.vectordb.AppendEntriesRequest\x1a%.grape.vectordb.AppendEntriesResponse\x12V\n\x0bRequestVote\x12\".grape.vectordb.RequestVoteRequest\x1a#.grape.vectordb.RequestVoteResponse\x12\x62\n\x0fInstallSnapshot\x12&.grape.vectordb.InstallSnapshotRequest\x1a\'.grape.vectordb.InstallSnapshotResponse\x12Y\n\x0cMigrateShard\x12#.grape.vectordb.MigrateShardRequest\x1a$.grape.vectordb.MigrateShardResponse\x12\x62\n\x0fRebalanceShards\x12&.grape.vectordb.RebalanceShardsRequest\x1a\'.grape.vectordb.RebalanceShardsResponse\x12Y\n\x0cGetShardInfo\x12#.grape.vectordb.GetShardInfoRequest\x1a$.grape.vectordb.GetShardInfoResponse\x12M\n\x08GetStats\x12\x1f.grape.vectordb.GetStatsRequest\x1a .grape.vectordb.GetStatsResponse\x12S\n\nGetMetrics\x12!.grape.vectordb.GetMetricsRequest\x1a\".grape.vectordb.GetMetricsResponse\x12M\n\x08Internal\x12\x1f.grape.vectordb.InternalRequest\x1a .grape.vectordb.InternalResponseb\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'proto.vector_db_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _POINT_PAYLOADENTRY._options = None
  _POINT_PAYLOADENTRY._serialized_options = b'8\001'
  _DOCUMENT_METADATAENTRY._options = None
  _DOCUMENT_METADATAENTRY._serialized_options = b'8\001'
  _SEARCHRESULT_PAYLOADENTRY._options = None
  _SEARCHRESULT_PAYLOADENTRY._serialized_options = b'8\001'
  _UPSERTVECTORRESPONSE_SESSIONVERSIONSENTRY._options = None
  _UPSERTVECTORRESPONSE_SESSIONVERSIONSENTRY._serialized_options = b'8\001'
  _DELETEVECTORRESPONSE_SESSIONVERSIONSENTRY._options = None
  _DELETEVECTORRESPONSE_SESSIONVERSIONSENTRY._serialized_options = b'8\001'
  _SEARCHVECTORSREQUEST_MINVERSIONSENTRY._options = None
  _SEARCHVECTORSREQUEST_MINVERSIONSENTRY._serialized_options = b'8\001'
  _NODEINFO_LABELSENTRY._options = None
  _NODEINFO_LABELSENTRY._serialized_options = b'8\001'
  _INTERNALREQUEST._serialized_start=41
  _INTERNALREQUEST._serialized_end=109
  _INTERNALRESPONSE._serialized_start=111
  _INTERNALRESPONSE._serialized_end=161
  _VECTOR._serialized_start=163
  _VECTOR._serialized_end=187
  _POINT._serialized_start=190
  _POINT._serialized_end=350
  _POINT_PAYLOADENTRY._serialized_start=304
  _POINT_PAYLOADENTRY._serialized_end=350
  _DOCUMENT._serialized_start=353
  _DOCUMENT._serialized_end=566
  _DOCUMENT_METADATAENTRY._serialized_start=519
  _DOCUMENT_METADATAENTRY._serialized_end=566
  _SEARCHRESULT._serialized_start=569
  _SEARCHRESULT._serialized_end=735
  _SEARCHRESULT_PAYLOADENTRY._serialized_start=304
  _SEARCHRESULT_PAYLOADENTRY._serialized_end=350
  _UPSERTVECTORREQUEST._serialized_start=737
  _UPSERTVECTORREQUEST._serialized_end=797
  _UPSERTVECTORRESPONSE._serialized_start=800
  _UPSERTVECTORRESPONSE._serialized_end=996
  _UPSERTVECTORRESPONSE_SESSIONVERSIONSENTRY._serialized_start=942
  _UPSERTVECTORRESPONSE_SESSIONVERSIONSENTRY._serialized_end=996
  _DELETEVECTORREQUEST._serialized_start=998
  _DELETEVECTORREQUEST._serialized_end=1032
  _DELETEVECTORRESPONSE._serialized_start=1035
  _DELETEVECTORRESPONSE._serialized_end=1230
  _DELETEVECTORRESPONSE_SESSIONVERSIONSENTRY._serialized_start=942
  _DELETEVECTORRESPONSE_SESSIONVERSIONSENTRY._serialized_end=996
  _SEARCHVECTORSREQUEST._serialized_start=1233
  _SEARCHVECTORSREQUEST._serialized_end=1539
  _SEARCHVECTORSREQUEST_MINVERSIONSENTRY._serialized_start=1489
  _SEARCHVECTORSREQUEST_MINVERSIONSENTRY._serialized_end=1539
  _SEARCHVECTORSRESPONSE._serialized_start=1541
  _SEARCHVECTORSRESPONSE._serialized_end=1648
  _GETVECTORREQUEST._serialized_start=1650
  _GETVECTORREQUEST._serialized_end=1680
  _GETVECTORRESPONSE._serialized_start=1682
  _GETVECTORRESPONSE._serialized_end=1754
  _ADDDOCUMENTREQUEST._serialized_start=1756
  _ADDDOCUMENTREQUEST._serialized_end=1821
  _ADDDOCUMENTRESPONSE._serialized_start=1823
  _ADDDOCUMENTRESPONSE._serialized_end=1872
  _GETDOCUMENTREQUEST._serialized_start=1874
  _GETDOCUMENTREQUEST._serialized_end=1906
  _GETDOCUMENTRESPONSE._serialized_start=1908
  _GETDOCUMENTRESPONSE._serialized_end=1988
  _SEARCHDOCUMENTSREQUEST._serialized_start=1990
  _SEARCHDOCUMENTSREQUEST._serialized_end=2094
  _SEARCHDOCUMENTSRESPONSE._serialized_start=2096
  _SEARCHDOCUMENTSRESPONSE._serialized_end=2183
  _DELETEDOCUMENTREQUEST._serialized_start=2185
  _DELETEDOCUMENTREQUEST._serialized_end=2221
  _DELETEDOCUMENTRESPONSE._serialized_start=2223
  _DELETEDOCUMENTRESPONSE._serialized_end=2279
  _NODEINFO._serialized_start=2282
  _NODEINFO._serialized_end=2442
  _NODEINFO_LABELSENTRY._serialized_start=2397
  _NODEINFO_LABELSENTRY._serialized_end=2442
  _JOINCLUSTERREQUEST._serialized_start=2444
  _JOINCLUSTERREQUEST._serialized_end=2504
  _JOINCLUSTERRESPONSE._serialized_start=2506
  _JOINCLUSTERRESPONSE._serialized_end=2603
  _LEAVECLUSTERREQUEST._serialized_start=2605
  _LEAVECLUSTERREQUEST._serialized_end=2643
  _LEAVECLUSTERRESPONSE._serialized_start=2645
  _LEAVECLUSTERRESPONSE._serialized_end=2679
  _GETCLUSTERINFOREQUEST._serialized_start=2681
  _GETCLUSTERINFOREQUEST._serialized_end=2704
  _GETCLUSTERINFORESPONSE._serialized_start=2706
  _GETCLUSTERINFORESPONSE._serialized_end=2833
  _HEARTBEATREQUEST._serialized_start=2835
  _HEARTBEATREQUEST._serialized_end=2898
  _HEARTBEATRESPONSE._serialized_start=2900
  _HEARTBEATRESPONSE._serialized_end=2945
  _LOGENTRY._serialized_start=2947
  _LOGENTRY._serialized_end=3020
  _APPENDENTRIESREQUEST._serialized_start=3023
  _APPENDENTRIESREQUEST._serialized_end=3191
  _APPENDENTRIESRESPONSE._serialized_start=3193
  _APPENDENTRIESRESPONSE._serialized_end=3268
  _REQUESTVOTEREQUEST._serialized_start=3270
  _REQUESTVOTEREQUEST._serialized_end=3373
  _REQUESTVOTERESPONSE._serialized_start=3375
  _REQUESTVOTERESPONSE._serialized_end=3432
  _INSTALLSNAPSHOTREQUEST._serialized_start=3435
  _INSTALLSNAPSHOTREQUEST._serialized_end=3563
  _INSTALLSNAPSHOTRESPONSE._serialized_start=3565
  _INSTALLSNAPSHOTRESPONSE._serialized_end=3616
  _MIGRATESHARDREQUEST._serialized_start=3618
  _MIGRATESHARDREQUEST._serialized_end=3693
  _MIGRATESHARDRESPONSE._serialized_start=3695
  _MIGRATESHARDRESPONSE._serialized_end=3744
  _REBALANCESHARDSREQUEST._serialized_start=3746
  _REBALANCESHARDSREQUEST._serialized_end=3770
  _REBALANCESHARDSRESPONSE._serialized_start=3772
  _REBALANCESHARDSRESPONSE._serialized_end=3824
  _GETSHARDINFOREQUEST._serialized_start=3826
  _GETSHARDINFOREQUEST._serialized_end=3865
  _GETSHARDINFORESPONSE._serialized_start=3867
  _GETSHARDINFORESPONSE._serialized_end=3988
  _GETSTATSREQUEST._serialized_start=3990
  _GETSTATSREQUEST._serialized_end=4007
  _GETSTATSRESPONSE._serialized_start=4009
  _GETSTATSRESPONSE._serialized_end=4132
  _GETMETRICSREQUEST._serialized_start=4134
  _GETMETRICSREQUEST._serialized_end=4153
  _GETMETRICSRESPONSE._serialized_start=4155
  _GETMETRICSRESPONSE._serialized_end=4200
  _VECTORDBSERVICE._serialized_start=4203
  _VECTORDBSERVICE._serialized_end=6116
# @@protoc_insertion_point(module_scope)
