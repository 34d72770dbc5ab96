# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: gateway.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\rgateway.proto\x12\x10gateway_protocol\"\x11\n\x0fTopologyRequest\"\xa0\x02\n\tPartition\x12\x13\n\x0bpartitionId\x18\x01 \x01(\x05\x12=\n\x04role\x18\x02 \x01(\x0e\x32/.gateway_protocol.Partition.PartitionBrokerRole\x12\x41\n\x06health\x18\x03 \x01(\x0e\x32\x31.gateway_protocol.Partition.PartitionBrokerHealth\"=\n\x13PartitionBrokerRole\x12\n\n\x06LEADER\x10\x00\x12\x0c\n\x08\x46OLLOWER\x10\x01\x12\x0c\n\x08INACTIVE\x10\x02\"=\n\x15PartitionBrokerHealth\x12\x0b\n\x07HEALTHY\x10\x00\x12\r\n\tUNHEALTHY\x10\x01\x12\x08\n\x04\x44\x45\x41\x44\x10\x02\"z\n\nBrokerInfo\x12\x0e\n\x06nodeId\x18\x01 \x01(\x05\x12\x0c\n\x04host\x18\x02 \x01(\t\x12\x0c\n\x04port\x18\x03 \x01(\x05\x12/\n\npartitions\x18\x04 \x03(\x0b\x32\x1b.gateway_protocol.Partition\x12\x0f\n\x07version\x18\x05 \x01(\t\"\xa2\x01\n\x10TopologyResponse\x12-\n\x07\x62rokers\x18\x01 \x03(\x0b\x32\x1c.gateway_protocol.BrokerInfo\x12\x13\n\x0b\x63lusterSize\x18\x02 \x01(\x05\x12\x17\n\x0fpartitionsCount\x18\x03 \x01(\x05\x12\x19\n\x11replicationFactor\x18\x04 \x01(\x05\x12\x16\n\x0egatewayVersion\x18\x05 \x01(\t\")\n\x08Resource\x12\x0c\n\x04name\x18\x01 \x01(\t\x12\x0f\n\x07\x63ontent\x18\x02 \x01(\x0c\"X\n\x15\x44\x65ployResourceRequest\x12-\n\tresources\x18\x01 \x03(\x0b\x32\x1a.gateway_protocol.Resource\x12\x10\n\x08tenantId\x18\x02 \x01(\t\"\x7f\n\x0fProcessMetadata\x12\x15\n\rbpmnProcessId\x18\x01 \x01(\t\x12\x0f\n\x07version\x18\x02 \x01(\x05\x12\x1c\n\x14processDefinitionKey\x18\x03 \x01(\x03\x12\x14\n\x0cresourceName\x18\x04 \x01(\t\x12\x10\n\x08tenantId\x18\x05 \x01(\t\"\xbe\x01\n\x10\x44\x65\x63isionMetadata\x12\x15\n\rdmnDecisionId\x18\x01 \x01(\t\x12\x17\n\x0f\x64mnDecisionName\x18\x02 \x01(\t\x12\x0f\n\x07version\x18\x03 \x01(\x05\x12\x13\n\x0b\x64\x65\x63isionKey\x18\x04 \x01(\x03\x12!\n\x19\x64mnDecisionRequirementsId\x18\x05 \x01(\t\x12\x1f\n\x17\x64\x65\x63isionRequirementsKey\x18\x06 \x01(\x03\x12\x10\n\x08tenantId\x18\x07 \x01(\t\"\xc0\x01\n\x1c\x44\x65\x63isionRequirementsMetadata\x12!\n\x19\x64mnDecisionRequirementsId\x18\x01 \x01(\t\x12#\n\x1b\x64mnDecisionRequirementsName\x18\x02 \x01(\t\x12\x0f\n\x07version\x18\x03 \x01(\x05\x12\x1f\n\x17\x64\x65\x63isionRequirementsKey\x18\x04 \x01(\x03\x12\x14\n\x0cresourceName\x18\x05 \x01(\t\x12\x10\n\x08tenantId\x18\x06 \x01(\t\"h\n\x0c\x46ormMetadata\x12\x0e\n\x06\x66ormId\x18\x01 \x01(\t\x12\x0f\n\x07version\x18\x02 \x01(\x05\x12\x0f\n\x07\x66ormKey\x18\x03 \x01(\x03\x12\x14\n\x0cresourceName\x18\x04 \x01(\t\x12\x10\n\x08tenantId\x18\x05 \x01(\t\"\x86\x02\n\nDeployment\x12\x34\n\x07process\x18\x01 \x01(\x0b\x32!.gateway_protocol.ProcessMetadataH\x00\x12\x36\n\x08\x64\x65\x63ision\x18\x02 \x01(\x0b\x32\".gateway_protocol.DecisionMetadataH\x00\x12N\n\x14\x64\x65\x63isionRequirements\x18\x03 \x01(\x0b\x32..gateway_protocol.DecisionRequirementsMetadataH\x00\x12.\n\x04\x66orm\x18\x04 \x01(\x0b\x32\x1e.gateway_protocol.FormMetadataH\x00\x42\n\n\x08Metadata\"j\n\x16\x44\x65ployResourceResponse\x12\x0b\n\x03key\x18\x01 \x01(\x03\x12\x31\n\x0b\x64\x65ployments\x18\x02 \x03(\x0b\x32\x1c.gateway_protocol.Deployment\x12\x10\n\x08tenantId\x18\x03 \x01(\t\"\xfb\x01\n\x1c\x43reateProcessInstanceRequest\x12\x1c\n\x14processDefinitionKey\x18\x01 \x01(\x03\x12\x15\n\rbpmnProcessId\x18\x02 \x01(\t\x12\x0f\n\x07version\x18\x03 \x01(\x05\x12\x11\n\tvariables\x18\x04 \x01(\t\x12T\n\x11startInstructions\x18\x05 \x03(\x0b\x32\x39.gateway_protocol.ProcessInstanceCreationStartInstruction\x12\x10\n\x08tenantId\x18\x06 \x01(\t\x12\x1a\n\x12operationReference\x18\x07 \x01(\x03\"<\n\'ProcessInstanceCreationStartInstruction\x12\x11\n\telementId\x18\x01 \x01(\t\"\x93\x01\n\x1d\x43reateProcessInstanceResponse\x12\x1c\n\x14processDefinitionKey\x18\x01 \x01(\x03\x12\x15\n\rbpmnProcessId\x18\x02 \x01(\t\x12\x0f\n\x07version\x18\x03 \x01(\x05\x12\x1a\n\x12processInstanceKey\x18\x04 \x01(\x03\x12\x10\n\x08tenantId\x18\x05 \x01(\t\"\x99\x01\n&CreateProcessInstanceWithResultRequest\x12?\n\x07request\x18\x01 \x01(\x0b\x32..gateway_protocol.CreateProcessInstanceRequest\x12\x16\n\x0erequestTimeout\x18\x02 \x01(\x03\x12\x16\n\x0e\x66\x65tchVariables\x18\x03 \x03(\t\"\xb0\x01\n\'CreateProcessInstanceWithResultResponse\x12\x1c\n\x14processDefinitionKey\x18\x01 \x01(\x03\x12\x15\n\rbpmnProcessId\x18\x02 \x01(\t\x12\x0f\n\x07version\x18\x03 \x01(\x05\x12\x1a\n\x12processInstanceKey\x18\x04 \x01(\x03\x12\x11\n\tvariables\x18\x05 \x01(\t\x12\x10\n\x08tenantId\x18\x06 \x01(\t\"V\n\x1c\x43\x61ncelProcessInstanceRequest\x12\x1a\n\x12processInstanceKey\x18\x01 \x01(\x03\x12\x1a\n\x12operationReference\x18\x02 \x01(\x03\"\x1f\n\x1d\x43\x61ncelProcessInstanceResponse\"\x89\x01\n\x15PublishMessageRequest\x12\x0c\n\x04name\x18\x01 \x01(\t\x12\x16\n\x0e\x63orrelationKey\x18\x02 \x01(\t\x12\x12\n\ntimeToLive\x18\x03 \x01(\x03\x12\x11\n\tmessageId\x18\x04 \x01(\t\x12\x11\n\tvariables\x18\x05 \x01(\t\x12\x10\n\x08tenantId\x18\x06 \x01(\t\"7\n\x16PublishMessageResponse\x12\x0b\n\x03key\x18\x01 \x01(\x03\x12\x10\n\x08tenantId\x18\x02 \x01(\t\"\xa1\x01\n\x13\x41\x63tivateJobsRequest\x12\x0c\n\x04type\x18\x01 \x01(\t\x12\x0e\n\x06worker\x18\x02 \x01(\t\x12\x0f\n\x07timeout\x18\x03 \x01(\x03\x12\x19\n\x11maxJobsToActivate\x18\x04 \x01(\x05\x12\x15\n\rfetchVariable\x18\x05 \x03(\t\x12\x16\n\x0erequestTimeout\x18\x06 \x01(\x03\x12\x11\n\ttenantIds\x18\x07 \x03(\t\"\xba\x02\n\x0c\x41\x63tivatedJob\x12\x0b\n\x03key\x18\x01 \x01(\x03\x12\x0c\n\x04type\x18\x02 \x01(\t\x12\x1a\n\x12processInstanceKey\x18\x03 \x01(\x03\x12\x15\n\rbpmnProcessId\x18\x04 \x01(\t\x12 \n\x18processDefinitionVersion\x18\x05 \x01(\x05\x12\x1c\n\x14processDefinitionKey\x18\x06 \x01(\x03\x12\x11\n\telementId\x18\x07 \x01(\t\x12\x1a\n\x12\x65lementInstanceKey\x18\x08 \x01(\x03\x12\x15\n\rcustomHeaders\x18\t \x01(\t\x12\x0e\n\x06worker\x18\n \x01(\t\x12\x0f\n\x07retries\x18\x0b \x01(\x05\x12\x10\n\x08\x64\x65\x61\x64line\x18\x0c \x01(\x03\x12\x11\n\tvariables\x18\r \x01(\t\x12\x10\n\x08tenantId\x18\x0e \x01(\t\"D\n\x14\x41\x63tivateJobsResponse\x12,\n\x04jobs\x18\x01 \x03(\x0b\x32\x1e.gateway_protocol.ActivatedJob\"u\n\x1aStreamActivatedJobsRequest\x12\x0c\n\x04type\x18\x01 \x01(\t\x12\x0e\n\x06worker\x18\x02 \x01(\t\x12\x0f\n\x07timeout\x18\x03 \x01(\x03\x12\x15\n\rfetchVariable\x18\x05 \x03(\t\x12\x11\n\ttenantIds\x18\x06 \x03(\t\"7\n\x12\x43ompleteJobRequest\x12\x0e\n\x06jobKey\x18\x01 \x01(\x03\x12\x11\n\tvariables\x18\x02 \x01(\t\"\x15\n\x13\x43ompleteJobResponse\"p\n\x0e\x46\x61ilJobRequest\x12\x0e\n\x06jobKey\x18\x01 \x01(\x03\x12\x0f\n\x07retries\x18\x02 \x01(\x05\x12\x14\n\x0c\x65rrorMessage\x18\x03 \x01(\t\x12\x14\n\x0cretryBackOff\x18\x04 \x01(\x03\x12\x11\n\tvariables\x18\x05 \x01(\t\"\x11\n\x0f\x46\x61ilJobResponse\"_\n\x11ThrowErrorRequest\x12\x0e\n\x06jobKey\x18\x01 \x01(\x03\x12\x11\n\terrorCode\x18\x02 \x01(\t\x12\x14\n\x0c\x65rrorMessage\x18\x03 \x01(\t\x12\x11\n\tvariables\x18\x04 \x01(\t\"\x14\n\x12ThrowErrorResponse\"V\n\x17UpdateJobRetriesRequest\x12\x0e\n\x06jobKey\x18\x01 \x01(\x03\x12\x0f\n\x07retries\x18\x02 \x01(\x05\x12\x1a\n\x12operationReference\x18\x03 \x01(\x03\"\x1a\n\x18UpdateJobRetriesResponse\"V\n\x17UpdateJobTimeoutRequest\x12\x0e\n\x06jobKey\x18\x01 \x01(\x03\x12\x0f\n\x07timeout\x18\x02 \x01(\x03\x12\x1a\n\x12operationReference\x18\x03 \x01(\x03\"\x1a\n\x18UpdateJobTimeoutResponse\"o\n\x13SetVariablesRequest\x12\x1a\n\x12\x65lementInstanceKey\x18\x01 \x01(\x03\x12\x11\n\tvariables\x18\x02 \x01(\t\x12\r\n\x05local\x18\x03 \x01(\x08\x12\x1a\n\x12operationReference\x18\x04 \x01(\x03\"#\n\x14SetVariablesResponse\x12\x0b\n\x03key\x18\x01 \x01(\x03\"I\n\x16ResolveIncidentRequest\x12\x13\n\x0bincidentKey\x18\x01 \x01(\x03\x12\x1a\n\x12operationReference\x18\x02 \x01(\x03\"\x19\n\x17ResolveIncidentResponse\"Q\n\x16\x42roadcastSignalRequest\x12\x12\n\nsignalName\x18\x01 \x01(\t\x12\x11\n\tvariables\x18\x02 \x01(\t\x12\x10\n\x08tenantId\x18\x03 \x01(\t\"8\n\x17\x42roadcastSignalResponse\x12\x0b\n\x03key\x18\x01 \x01(\x03\x12\x10\n\x08tenantId\x18\x02 \x01(\t\"\xbc\x04\n\x1cModifyProcessInstanceRequest\x12\x1a\n\x12processInstanceKey\x18\x01 \x01(\x03\x12`\n\x14\x61\x63tivateInstructions\x18\x02 \x03(\x0b\x32\x42.gateway_protocol.ModifyProcessInstanceRequest.ActivateInstruction\x12\x62\n\x15terminateInstructions\x18\x03 \x03(\x0b\x32\x43.gateway_protocol.ModifyProcessInstanceRequest.TerminateInstruction\x12\x1a\n\x12operationReference\x18\x04 \x01(\x03\x1a\xae\x01\n\x13\x41\x63tivateInstruction\x12\x11\n\telementId\x18\x01 \x01(\t\x12\"\n\x1a\x61ncestorElementInstanceKey\x18\x02 \x01(\x03\x12`\n\x14variableInstructions\x18\x03 \x03(\x0b\x32\x42.gateway_protocol.ModifyProcessInstanceRequest.VariableInstruction\x1a\x39\n\x13VariableInstruction\x12\x11\n\tvariables\x18\x01 \x01(\t\x12\x0f\n\x07scopeId\x18\x02 \x01(\t\x1a\x32\n\x14TerminateInstruction\x12\x1a\n\x12\x65lementInstanceKey\x18\x01 \x01(\x03\"\x1f\n\x1dModifyProcessInstanceResponse\"\x8c\x03\n\x1dMigrateProcessInstanceRequest\x12\x1a\n\x12processInstanceKey\x18\x01 \x01(\x03\x12T\n\rmigrationPlan\x18\x02 \x01(\x0b\x32=.gateway_protocol.MigrateProcessInstanceRequest.MigrationPlan\x12\x1a\n\x12operationReference\x18\x03 \x01(\x03\x1a\x94\x01\n\rMigrationPlan\x12\"\n\x1atargetProcessDefinitionKey\x18\x01 \x01(\x03\x12_\n\x13mappingInstructions\x18\x02 \x03(\x0b\x32\x42.gateway_protocol.MigrateProcessInstanceRequest.MappingInstruction\x1a\x46\n\x12MappingInstruction\x12\x17\n\x0fsourceElementId\x18\x01 \x01(\t\x12\x17\n\x0ftargetElementId\x18\x02 \x01(\t\" \n\x1eMigrateProcessInstanceResponse\"g\n\x17\x45valuateDecisionRequest\x12\x13\n\x0b\x64\x65\x63isionKey\x18\x01 \x01(\x03\x12\x12\n\ndecisionId\x18\x02 \x01(\t\x12\x11\n\tvariables\x18\x03 \x01(\t\x12\x10\n\x08tenantId\x18\x04 \x01(\t\"\xed\x02\n\x18\x45valuateDecisionResponse\x12\x13\n\x0b\x64\x65\x63isionKey\x18\x01 \x01(\x03\x12\x12\n\ndecisionId\x18\x02 \x01(\t\x12\x14\n\x0c\x64\x65\x63isionName\x18\x03 \x01(\t\x12\x17\n\x0f\x64\x65\x63isionVersion\x18\x04 \x01(\x05\x12\x1e\n\x16\x64\x65\x63isionRequirementsId\x18\x05 \x01(\t\x12\x1f\n\x17\x64\x65\x63isionRequirementsKey\x18\x06 \x01(\x03\x12\x16\n\x0e\x64\x65\x63isionOutput\x18\x07 \x01(\t\x12?\n\x12\x65valuatedDecisions\x18\x08 \x03(\x0b\x32#.gateway_protocol.EvaluatedDecision\x12\x18\n\x10\x66\x61iledDecisionId\x18\t \x01(\t\x12\x16\n\x0e\x66\x61ilureMessage\x18\n \x01(\t\x12\x10\n\x08tenantId\x18\x0b \x01(\t\x12\x1b\n\x13\x64\x65\x63isionInstanceKey\x18\x0c \x01(\x03\"\xab\x02\n\x11\x45valuatedDecision\x12\x13\n\x0b\x64\x65\x63isionKey\x18\x01 \x01(\x03\x12\x12\n\ndecisionId\x18\x02 \x01(\t\x12\x14\n\x0c\x64\x65\x63isionName\x18\x03 \x01(\t\x12\x17\n\x0f\x64\x65\x63isionVersion\x18\x04 \x01(\x05\x12\x14\n\x0c\x64\x65\x63isionType\x18\x05 \x01(\t\x12\x16\n\x0e\x64\x65\x63isionOutput\x18\x06 \x01(\t\x12;\n\x0cmatchedRules\x18\x07 \x03(\x0b\x32%.gateway_protocol.MatchedDecisionRule\x12\x41\n\x0f\x65valuatedInputs\x18\x08 \x03(\x0b\x32(.gateway_protocol.EvaluatedDecisionInput\x12\x10\n\x08tenantId\x18\t \x01(\t\"}\n\x13MatchedDecisionRule\x12\x0e\n\x06ruleId\x18\x01 \x01(\t\x12\x11\n\truleIndex\x18\x02 \x01(\x05\x12\x43\n\x10\x65valuatedOutputs\x18\x03 \x03(\x0b\x32).gateway_protocol.EvaluatedDecisionOutput\"P\n\x16\x45valuatedDecisionInput\x12\x0f\n\x07inputId\x18\x01 \x01(\t\x12\x11\n\tinputName\x18\x02 \x01(\t\x12\x12\n\ninputValue\x18\x03 \x01(\t\"T\n\x17\x45valuatedDecisionOutput\x12\x10\n\x08outputId\x18\x01 \x01(\t\x12\x12\n\noutputName\x18\x02 \x01(\t\x12\x13\n\x0boutputValue\x18\x03 \x01(\t\"H\n\x15\x44\x65leteResourceRequest\x12\x13\n\x0bresourceKey\x18\x01 \x01(\x03\x12\x1a\n\x12operationReference\x18\x02 \x01(\x03\"\x18\n\x16\x44\x65leteResourceResponse2\xf4\x10\n\x07Gateway\x12S\n\x08Topology\x12!.gateway_protocol.TopologyRequest\x1a\".gateway_protocol.TopologyResponse\"\x00\x12\x65\n\x0e\x44\x65ployResource\x12\'.gateway_protocol.DeployResourceRequest\x1a(.gateway_protocol.DeployResourceResponse\"\x00\x12z\n\x15\x43reateProcessInstance\x12..gateway_protocol.CreateProcessInstanceRequest\x1a/.gateway_protocol.CreateProcessInstanceResponse\"\x00\x12\x98\x01\n\x1f\x43reateProcessInstanceWithResult\x12\x38.gateway_protocol.CreateProcessInstanceWithResultRequest\x1a\x39.gateway_protocol.CreateProcessInstanceWithResultResponse\"\x00\x12z\n\x15\x43\x61ncelProcessInstance\x12..gateway_protocol.CancelProcessInstanceRequest\x1a/.gateway_protocol.CancelProcessInstanceResponse\"\x00\x12\x65\n\x0ePublishMessage\x12\'.gateway_protocol.PublishMessageRequest\x1a(.gateway_protocol.PublishMessageResponse\"\x00\x12\x61\n\x0c\x41\x63tivateJobs\x12%.gateway_protocol.ActivateJobsRequest\x1a&.gateway_protocol.ActivateJobsResponse\"\x00\x30\x01\x12g\n\x13StreamActivatedJobs\x12,.gateway_protocol.StreamActivatedJobsRequest\x1a\x1e.gateway_protocol.ActivatedJob\"\x00\x30\x01\x12\\\n\x0b\x43ompleteJob\x12$.gateway_protocol.CompleteJobRequest\x1a%.gateway_protocol.CompleteJobResponse\"\x00\x12P\n\x07\x46\x61ilJob\x12 .gateway_protocol.FailJobRequest\x1a!.gateway_protocol.FailJobResponse\"\x00\x12Y\n\nThrowError\x12#.gateway_protocol.ThrowErrorRequest\x1a$.gateway_protocol.ThrowErrorResponse\"\x00\x12k\n\x10UpdateJobRetries\x12).gateway_protocol.UpdateJobRetriesRequest\x1a*.gateway_protocol.UpdateJobRetriesResponse\"\x00\x12k\n\x10UpdateJobTimeout\x12).gateway_protocol.UpdateJobTimeoutRequest\x1a*.gateway_protocol.UpdateJobTimeoutResponse\"\x00\x12_\n\x0cSetVariables\x12%.gateway_protocol.SetVariablesRequest\x1a&.gateway_protocol.SetVariablesResponse\"\x00\x12h\n\x0fResolveIncident\x12(.gateway_protocol.ResolveIncidentRequest\x1a).gateway_protocol.ResolveIncidentResponse\"\x00\x12h\n\x0f\x42roadcastSignal\x12(.gateway_protocol.BroadcastSignalRequest\x1a).gateway_protocol.BroadcastSignalResponse\"\x00\x12z\n\x15ModifyProcessInstance\x12..gateway_protocol.ModifyProcessInstanceRequest\x1a/.gateway_protocol.ModifyProcessInstanceResponse\"\x00\x12}\n\x16MigrateProcessInstance\x12/.gateway_protocol.MigrateProcessInstanceRequest\x1a\x30.gateway_protocol.MigrateProcessInstanceResponse\"\x00\x12k\n\x10\x45valuateDecision\x12).gateway_protocol.EvaluateDecisionRequest\x1a*.gateway_protocol.EvaluateDecisionResponse\"\x00\x12\x65\n\x0e\x44\x65leteResource\x12\'.gateway_protocol.DeleteResourceRequest\x1a(.gateway_protocol.DeleteResourceResponse\"\x00\x62\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'gateway_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _TOPOLOGYREQUEST._serialized_start=35
  _TOPOLOGYREQUEST._serialized_end=52
  _PARTITION._serialized_start=55
  _PARTITION._serialized_end=343
  _PARTITION_PARTITIONBROKERROLE._serialized_start=219
  _PARTITION_PARTITIONBROKERROLE._serialized_end=280
  _PARTITION_PARTITIONBROKERHEALTH._serialized_start=282
  _PARTITION_PARTITIONBROKERHEALTH._serialized_end=343
  _BROKERINFO._serialized_start=345
  _BROKERINFO._serialized_end=467
  _TOPOLOGYRESPONSE._serialized_start=470
  _TOPOLOGYRESPONSE._serialized_end=632
  _RESOURCE._serialized_start=634
  _RESOURCE._serialized_end=675
  _DEPLOYRESOURCEREQUEST._serialized_start=677
  _DEPLOYRESOURCEREQUEST._serialized_end=765
  _PROCESSMETADATA._serialized_start=767
  _PROCESSMETADATA._serialized_end=894
  _DECISIONMETADATA._serialized_start=897
  _DECISIONMETADATA._serialized_end=1087
  _DECISIONREQUIREMENTSMETADATA._serialized_start=1090
  _DECISIONREQUIREMENTSMETADATA._serialized_end=1282
  _FORMMETADATA._serialized_start=1284
  _FORMMETADATA._serialized_end=1388
  _DEPLOYMENT._serialized_start=1391
  _DEPLOYMENT._serialized_end=1653
  _DEPLOYRESOURCERESPONSE._serialized_start=1655
  _DEPLOYRESOURCERESPONSE._serialized_end=1761
  _CREATEPROCESSINSTANCEREQUEST._serialized_start=1764
  _CREATEPROCESSINSTANCEREQUEST._serialized_end=2015
  _PROCESSINSTANCECREATIONSTARTINSTRUCTION._serialized_start=2017
  _PROCESSINSTANCECREATIONSTARTINSTRUCTION._serialized_end=2077
  _CREATEPROCESSINSTANCERESPONSE._serialized_start=2080
  _CREATEPROCESSINSTANCERESPONSE._serialized_end=2227
  _CREATEPROCESSINSTANCEWITHRESULTREQUEST._serialized_start=2230
  _CREATEPROCESSINSTANCEWITHRESULTREQUEST._serialized_end=2383
  _CREATEPROCESSINSTANCEWITHRESULTRESPONSE._serialized_start=2386
  _CREATEPROCESSINSTANCEWITHRESULTRESPONSE._serialized_end=2562
  _CANCELPROCESSINSTANCEREQUEST._serialized_start=2564
  _CANCELPROCESSINSTANCEREQUEST._serialized_end=2650
  _CANCELPROCESSINSTANCERESPONSE._serialized_start=2652
  _CANCELPROCESSINSTANCERESPONSE._serialized_end=2683
  _PUBLISHMESSAGEREQUEST._serialized_start=2686
  _PUBLISHMESSAGEREQUEST._serialized_end=2823
  _PUBLISHMESSAGERESPONSE._serialized_start=2825
  _PUBLISHMESSAGERESPONSE._serialized_end=2880
  _ACTIVATEJOBSREQUEST._serialized_start=2883
  _ACTIVATEJOBSREQUEST._serialized_end=3044
  _ACTIVATEDJOB._serialized_start=3047
  _ACTIVATEDJOB._serialized_end=3361
  _ACTIVATEJOBSRESPONSE._serialized_start=3363
  _ACTIVATEJOBSRESPONSE._serialized_end=3431
  _STREAMACTIVATEDJOBSREQUEST._serialized_start=3433
  _STREAMACTIVATEDJOBSREQUEST._serialized_end=3550
  _COMPLETEJOBREQUEST._serialized_start=3552
  _COMPLETEJOBREQUEST._serialized_end=3607
  _COMPLETEJOBRESPONSE._serialized_start=3609
  _COMPLETEJOBRESPONSE._serialized_end=3630
  _FAILJOBREQUEST._serialized_start=3632
  _FAILJOBREQUEST._serialized_end=3744
  _FAILJOBRESPONSE._serialized_start=3746
  _FAILJOBRESPONSE._serialized_end=3763
  _THROWERRORREQUEST._serialized_start=3765
  _THROWERRORREQUEST._serialized_end=3860
  _THROWERRORRESPONSE._serialized_start=3862
  _THROWERRORRESPONSE._serialized_end=3882
  _UPDATEJOBRETRIESREQUEST._serialized_start=3884
  _UPDATEJOBRETRIESREQUEST._serialized_end=3970
  _UPDATEJOBRETRIESRESPONSE._serialized_start=3972
  _UPDATEJOBRETRIESRESPONSE._serialized_end=3998
  _UPDATEJOBTIMEOUTREQUEST._serialized_start=4000
  _UPDATEJOBTIMEOUTREQUEST._serialized_end=4086
  _UPDATEJOBTIMEOUTRESPONSE._serialized_start=4088
  _UPDATEJOBTIMEOUTRESPONSE._serialized_end=4114
  _SETVARIABLESREQUEST._serialized_start=4116
  _SETVARIABLESREQUEST._serialized_end=4227
  _SETVARIABLESRESPONSE._serialized_start=4229
  _SETVARIABLESRESPONSE._serialized_end=4264
  _RESOLVEINCIDENTREQUEST._serialized_start=4266
  _RESOLVEINCIDENTREQUEST._serialized_end=4339
  _RESOLVEINCIDENTRESPONSE._serialized_start=4341
  _RESOLVEINCIDENTRESPONSE._serialized_end=4366
  _BROADCASTSIGNALREQUEST._serialized_start=4368
  _BROADCASTSIGNALREQUEST._serialized_end=4449
  _BROADCASTSIGNALRESPONSE._serialized_start=4451
  _BROADCASTSIGNALRESPONSE._serialized_end=4507
  _MODIFYPROCESSINSTANCEREQUEST._serialized_start=4510
  _MODIFYPROCESSINSTANCEREQUEST._serialized_end=5082
  _MODIFYPROCESSINSTANCEREQUEST_ACTIVATEINSTRUCTION._serialized_start=4797
  _MODIFYPROCESSINSTANCEREQUEST_ACTIVATEINSTRUCTION._serialized_end=4971
  _MODIFYPROCESSINSTANCEREQUEST_VARIABLEINSTRUCTION._serialized_start=4973
  _MODIFYPROCESSINSTANCEREQUEST_VARIABLEINSTRUCTION._serialized_end=5030
  _MODIFYPROCESSINSTANCEREQUEST_TERMINATEINSTRUCTION._serialized_start=5032
  _MODIFYPROCESSINSTANCEREQUEST_TERMINATEINSTRUCTION._serialized_end=5082
  _MODIFYPROCESSINSTANCERESPONSE._serialized_start=5084
  _MODIFYPROCESSINSTANCERESPONSE._serialized_end=5115
  _MIGRATEPROCESSINSTANCEREQUEST._serialized_start=5118
  _MIGRATEPROCESSINSTANCEREQUEST._serialized_end=5514
  _MIGRATEPROCESSINSTANCEREQUEST_MIGRATIONPLAN._serialized_start=5294
  _MIGRATEPROCESSINSTANCEREQUEST_MIGRATIONPLAN._serialized_end=5442
  _MIGRATEPROCESSINSTANCEREQUEST_MAPPINGINSTRUCTION._serialized_start=5444
  _MIGRATEPROCESSINSTANCEREQUEST_MAPPINGINSTRUCTION._serialized_end=5514
  _MIGRATEPROCESSINSTANCERESPONSE._serialized_start=5516
  _MIGRATEPROCESSINSTANCERESPONSE._serialized_end=5548
  _EVALUATEDECISIONREQUEST._serialized_start=5550
  _EVALUATEDECISIONREQUEST._serialized_end=5653
  _EVALUATEDECISIONRESPONSE._serialized_start=5656
  _EVALUATEDECISIONRESPONSE._serialized_end=6021
  _EVALUATEDDECISION._serialized_start=6024
  _EVALUATEDDECISION._serialized_end=6323
  _MATCHEDDECISIONRULE._serialized_start=6325
  _MATCHEDDECISIONRULE._serialized_end=6450
  _EVALUATEDDECISIONINPUT._serialized_start=6452
  _EVALUATEDDECISIONINPUT._serialized_end=6532
  _EVALUATEDDECISIONOUTPUT._serialized_start=6534
  _EVALUATEDDECISIONOUTPUT._serialized_end=6618
  _DELETERESOURCEREQUEST._serialized_start=6620
  _DELETERESOURCEREQUEST._serialized_end=6692
  _DELETERESOURCERESPONSE._serialized_start=6694
  _DELETERESOURCERESPONSE._serialized_end=6718
  _GATEWAY._serialized_start=6721
  _GATEWAY._serialized_end=8885
# @@protoc_insertion_point(module_scope)
