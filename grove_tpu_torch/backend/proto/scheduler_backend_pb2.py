# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: scheduler_backend.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x17scheduler_backend.proto\x12\x14grove_tpu.backend.v1\"1\n\x0eNamespacedName\x12\x11\n\tnamespace\x18\x01 \x01(\t\x12\x0c\n\x04name\x18\x02 \x01(\t\"/\n\x10ResourceQuantity\x12\x0c\n\x04name\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\x01\"=\n\x0ePackConstraint\x12\x14\n\x0crequired_key\x18\x01 \x01(\t\x12\x15\n\rpreferred_key\x18\x02 \x01(\t\"\xa2\x03\n\x08PodGroup\x12\x0c\n\x04name\x18\x01 \x01(\t\x12<\n\x0epod_references\x18\x02 \x03(\x0b\x32$.grove_tpu.backend.v1.NamespacedName\x12\x14\n\x0cmin_replicas\x18\x03 \x01(\x05\x12=\n\x0fpack_constraint\x18\x04 \x01(\x0b\x32$.grove_tpu.backend.v1.PackConstraint\x12@\n\x10per_pod_requests\x18\x05 \x03(\x0b\x32&.grove_tpu.backend.v1.ResourceQuantity\x12G\n\rnode_selector\x18\x06 \x03(\x0b\x32\x30.grove_tpu.backend.v1.PodGroup.NodeSelectorEntry\x12\x35\n\x0btolerations\x18\x07 \x03(\x0b\x32 .grove_tpu.backend.v1.Toleration\x1a\x33\n\x11NodeSelectorEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\t:\x02\x38\x01\"}\n\x15GroupConstraintConfig\x12\x0c\n\x04name\x18\x01 \x01(\t\x12\x17\n\x0fpod_group_names\x18\x02 \x03(\t\x12=\n\x0fpack_constraint\x18\x03 \x01(\x0b\x32$.grove_tpu.backend.v1.PackConstraint\"\xa3\x03\n\x0bPodGangSpec\x12\x0c\n\x04name\x18\x01 \x01(\t\x12\x11\n\tnamespace\x18\x02 \x01(\t\x12\x32\n\npod_groups\x18\x03 \x03(\x0b\x32\x1e.grove_tpu.backend.v1.PodGroup\x12=\n\x0fpack_constraint\x18\x04 \x01(\x0b\x32$.grove_tpu.backend.v1.PackConstraint\x12\x42\n\rgroup_configs\x18\x05 \x03(\x0b\x32+.grove_tpu.backend.v1.GroupConstraintConfig\x12\x1b\n\x13priority_class_name\x18\x06 \x01(\t\x12\x19\n\x11\x62\x61se_podgang_name\x18\x07 \x01(\t\x12\x43\n\x15reuse_reservation_ref\x18\x08 \x01(\x0b\x32$.grove_tpu.backend.v1.NamespacedName\x12\x12\n\nspread_key\x18\t \x01(\t\x12\x10\n\x08pcs_name\x18\n \x01(\t\x12\x19\n\x11pcs_replica_index\x18\x0b \x01(\x05\"3\n\x05Taint\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\t\x12\x0e\n\x06\x65\x66\x66\x65\x63t\x18\x03 \x01(\t\"J\n\nToleration\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\x10\n\x08operator\x18\x02 \x01(\t\x12\r\n\x05value\x18\x03 \x01(\t\x12\x0e\n\x06\x65\x66\x66\x65\x63t\x18\x04 \x01(\t\"\xf7\x01\n\x04Node\x12\x0c\n\x04name\x18\x01 \x01(\t\x12\x13\n\x0bschedulable\x18\x02 \x01(\x08\x12\x38\n\x08\x63\x61pacity\x18\x03 \x03(\x0b\x32&.grove_tpu.backend.v1.ResourceQuantity\x12\x36\n\x06labels\x18\x04 \x03(\x0b\x32&.grove_tpu.backend.v1.Node.LabelsEntry\x12+\n\x06taints\x18\x05 \x03(\x0b\x32\x1b.grove_tpu.backend.v1.Taint\x1a-\n\x0bLabelsEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\t:\x02\x38\x01\"7\n\rTopologyLevel\x12\x0e\n\x06\x64omain\x18\x01 \x01(\t\x12\x16\n\x0enode_label_key\x18\x02 \x01(\t\"\xce\x01\n\x0bInitRequest\x12\x35\n\x08topology\x18\x01 \x03(\x0b\x32#.grove_tpu.backend.v1.TopologyLevel\x12P\n\x10priority_classes\x18\x02 \x03(\x0b\x32\x36.grove_tpu.backend.v1.InitRequest.PriorityClassesEntry\x1a\x36\n\x14PriorityClassesEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\x05:\x02\x38\x01\"\x1c\n\x0cInitResponse\x12\x0c\n\x04name\x18\x01 \x01(\t\"I\n\x12SyncPodGangRequest\x12\x33\n\x08pod_gang\x18\x01 \x01(\x0b\x32!.grove_tpu.backend.v1.PodGangSpec\"\x15\n\x13SyncPodGangResponse\"9\n\x16OnPodGangDeleteRequest\x12\x11\n\tnamespace\x18\x01 \x01(\t\x12\x0c\n\x04name\x18\x02 \x01(\t\"\x19\n\x17OnPodGangDeleteResponse\"<\n\x11PreparePodRequest\x12\x10\n\x08pod_name\x18\x01 \x01(\t\x12\x15\n\rpod_gang_name\x18\x02 \x01(\t\"\xbf\x02\n\x12PreparePodResponse\x12\x16\n\x0escheduler_name\x18\x01 \x01(\t\x12\x18\n\x10scheduling_gates\x18\x02 \x03(\t\x12N\n\x0b\x61nnotations\x18\x03 \x03(\x0b\x32\x39.grove_tpu.backend.v1.PreparePodResponse.AnnotationsEntry\x12\x44\n\x06labels\x18\x04 \x03(\x0b\x32\x34.grove_tpu.backend.v1.PreparePodResponse.LabelsEntry\x1a\x32\n\x10\x41nnotationsEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\t:\x02\x38\x01\x1a-\n\x0bLabelsEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\t:\x02\x38\x01\"/\n\x1bValidatePodCliqueSetRequest\x12\x10\n\x08pcs_yaml\x18\x01 \x01(\t\".\n\x1cValidatePodCliqueSetResponse\x12\x0e\n\x06\x65rrors\x18\x01 \x03(\t\"W\n\x14UpdateClusterRequest\x12)\n\x05nodes\x18\x01 \x03(\x0b\x32\x1a.grove_tpu.backend.v1.Node\x12\x14\n\x0c\x66ull_replace\x18\x02 \x01(\x08\"+\n\x15UpdateClusterResponse\x12\x12\n\nnode_count\x18\x01 \x01(\x05\"\'\n\x12ReleasePodsRequest\x12\x11\n\tpod_names\x18\x01 \x03(\t\"\x15\n\x13ReleasePodsResponse\".\n\x07\x42inding\x12\x10\n\x08pod_name\x18\x01 \x01(\t\x12\x11\n\tnode_name\x18\x02 \x01(\t\"v\n\nGangResult\x12\x0c\n\x04name\x18\x01 \x01(\t\x12\x10\n\x08\x61\x64mitted\x18\x02 \x01(\x08\x12\x17\n\x0fplacement_score\x18\x03 \x01(\x02\x12/\n\x08\x62indings\x18\x04 \x03(\x0b\x32\x1d.grove_tpu.backend.v1.Binding\"\'\n\x0cSolveRequest\x12\x17\n\x0bspeculative\x18\x01 \x01(\x08\x42\x02\x18\x01\"V\n\rSolveResponse\x12/\n\x05gangs\x18\x01 \x03(\x0b\x32 .grove_tpu.backend.v1.GangResult\x12\x14\n\x0csolve_micros\x18\x02 \x01(\x03\x32\xb5\x06\n\x10SchedulerBackend\x12M\n\x04Init\x12!.grove_tpu.backend.v1.InitRequest\x1a\".grove_tpu.backend.v1.InitResponse\x12\x62\n\x0bSyncPodGang\x12(.grove_tpu.backend.v1.SyncPodGangRequest\x1a).grove_tpu.backend.v1.SyncPodGangResponse\x12n\n\x0fOnPodGangDelete\x12,.grove_tpu.backend.v1.OnPodGangDeleteRequest\x1a-.grove_tpu.backend.v1.OnPodGangDeleteResponse\x12_\n\nPreparePod\x12\'.grove_tpu.backend.v1.PreparePodRequest\x1a(.grove_tpu.backend.v1.PreparePodResponse\x12}\n\x14ValidatePodCliqueSet\x12\x31.grove_tpu.backend.v1.ValidatePodCliqueSetRequest\x1a\x32.grove_tpu.backend.v1.ValidatePodCliqueSetResponse\x12h\n\rUpdateCluster\x12*.grove_tpu.backend.v1.UpdateClusterRequest\x1a+.grove_tpu.backend.v1.UpdateClusterResponse\x12\x62\n\x0bReleasePods\x12(.grove_tpu.backend.v1.ReleasePodsRequest\x1a).grove_tpu.backend.v1.ReleasePodsResponse\x12P\n\x05Solve\x12\".grove_tpu.backend.v1.SolveRequest\x1a#.grove_tpu.backend.v1.SolveResponseb\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'scheduler_backend_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _PODGROUP_NODESELECTORENTRY._options = None
  _PODGROUP_NODESELECTORENTRY._serialized_options = b'8\001'
  _NODE_LABELSENTRY._options = None
  _NODE_LABELSENTRY._serialized_options = b'8\001'
  _INITREQUEST_PRIORITYCLASSESENTRY._options = None
  _INITREQUEST_PRIORITYCLASSESENTRY._serialized_options = b'8\001'
  _PREPAREPODRESPONSE_ANNOTATIONSENTRY._options = None
  _PREPAREPODRESPONSE_ANNOTATIONSENTRY._serialized_options = b'8\001'
  _PREPAREPODRESPONSE_LABELSENTRY._options = None
  _PREPAREPODRESPONSE_LABELSENTRY._serialized_options = b'8\001'
  _SOLVEREQUEST.fields_by_name['speculative']._options = None
  _SOLVEREQUEST.fields_by_name['speculative']._serialized_options = b'\030\001'
  _NAMESPACEDNAME._serialized_start=49
  _NAMESPACEDNAME._serialized_end=98
  _RESOURCEQUANTITY._serialized_start=100
  _RESOURCEQUANTITY._serialized_end=147
  _PACKCONSTRAINT._serialized_start=149
  _PACKCONSTRAINT._serialized_end=210
  _PODGROUP._serialized_start=213
  _PODGROUP._serialized_end=631
  _PODGROUP_NODESELECTORENTRY._serialized_start=580
  _PODGROUP_NODESELECTORENTRY._serialized_end=631
  _GROUPCONSTRAINTCONFIG._serialized_start=633
  _GROUPCONSTRAINTCONFIG._serialized_end=758
  _PODGANGSPEC._serialized_start=761
  _PODGANGSPEC._serialized_end=1180
  _TAINT._serialized_start=1182
  _TAINT._serialized_end=1233
  _TOLERATION._serialized_start=1235
  _TOLERATION._serialized_end=1309
  _NODE._serialized_start=1312
  _NODE._serialized_end=1559
  _NODE_LABELSENTRY._serialized_start=1514
  _NODE_LABELSENTRY._serialized_end=1559
  _TOPOLOGYLEVEL._serialized_start=1561
  _TOPOLOGYLEVEL._serialized_end=1616
  _INITREQUEST._serialized_start=1619
  _INITREQUEST._serialized_end=1825
  _INITREQUEST_PRIORITYCLASSESENTRY._serialized_start=1771
  _INITREQUEST_PRIORITYCLASSESENTRY._serialized_end=1825
  _INITRESPONSE._serialized_start=1827
  _INITRESPONSE._serialized_end=1855
  _SYNCPODGANGREQUEST._serialized_start=1857
  _SYNCPODGANGREQUEST._serialized_end=1930
  _SYNCPODGANGRESPONSE._serialized_start=1932
  _SYNCPODGANGRESPONSE._serialized_end=1953
  _ONPODGANGDELETEREQUEST._serialized_start=1955
  _ONPODGANGDELETEREQUEST._serialized_end=2012
  _ONPODGANGDELETERESPONSE._serialized_start=2014
  _ONPODGANGDELETERESPONSE._serialized_end=2039
  _PREPAREPODREQUEST._serialized_start=2041
  _PREPAREPODREQUEST._serialized_end=2101
  _PREPAREPODRESPONSE._serialized_start=2104
  _PREPAREPODRESPONSE._serialized_end=2423
  _PREPAREPODRESPONSE_ANNOTATIONSENTRY._serialized_start=2326
  _PREPAREPODRESPONSE_ANNOTATIONSENTRY._serialized_end=2376
  _PREPAREPODRESPONSE_LABELSENTRY._serialized_start=1514
  _PREPAREPODRESPONSE_LABELSENTRY._serialized_end=1559
  _VALIDATEPODCLIQUESETREQUEST._serialized_start=2425
  _VALIDATEPODCLIQUESETREQUEST._serialized_end=2472
  _VALIDATEPODCLIQUESETRESPONSE._serialized_start=2474
  _VALIDATEPODCLIQUESETRESPONSE._serialized_end=2520
  _UPDATECLUSTERREQUEST._serialized_start=2522
  _UPDATECLUSTERREQUEST._serialized_end=2609
  _UPDATECLUSTERRESPONSE._serialized_start=2611
  _UPDATECLUSTERRESPONSE._serialized_end=2654
  _RELEASEPODSREQUEST._serialized_start=2656
  _RELEASEPODSREQUEST._serialized_end=2695
  _RELEASEPODSRESPONSE._serialized_start=2697
  _RELEASEPODSRESPONSE._serialized_end=2718
  _BINDING._serialized_start=2720
  _BINDING._serialized_end=2766
  _GANGRESULT._serialized_start=2768
  _GANGRESULT._serialized_end=2886
  _SOLVEREQUEST._serialized_start=2888
  _SOLVEREQUEST._serialized_end=2927
  _SOLVERESPONSE._serialized_start=2929
  _SOLVERESPONSE._serialized_end=3015
  _SCHEDULERBACKEND._serialized_start=3018
  _SCHEDULERBACKEND._serialized_end=3839
# @@protoc_insertion_point(module_scope)
