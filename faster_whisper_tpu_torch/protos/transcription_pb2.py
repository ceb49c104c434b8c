# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: transcription.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x13transcription.proto\x12\x03\x66wt\"\xfb\x02\n\x11TranscribeRequest\x12\r\n\x05\x61udio\x18\x01 \x01(\x0c\x12\x10\n\x08language\x18\x02 \x01(\t\x12\x0c\n\x04task\x18\x03 \x01(\t\x12\x11\n\tbeam_size\x18\x04 \x01(\x05\x12\x12\n\nbatch_size\x18\x05 \x01(\x05\x12\x12\n\nsequential\x18\x06 \x01(\x08\x12\x13\n\x0btemperature\x18\x07 \x03(\x02\x12\x17\n\x0fword_timestamps\x18\x08 \x01(\x08\x12\x12\n\nvad_filter\x18\t \x01(\x08\x12\x16\n\x0einitial_prompt\x18\n \x01(\t\x12\x10\n\x08hotwords\x18\x0b \x01(\t\x12\x16\n\x0emax_new_tokens\x18\x0c \x01(\x05\x12\x1a\n\x12without_timestamps\x18\r \x01(\x08\x12\x0e\n\x06prefix\x18\x0e \x01(\t\x12\x14\n\x0cmultilingual\x18\x0f \x01(\x08\x12%\n\x1dno_condition_on_previous_text\x18\x10 \x01(\x08\x12\x0f\n\x07verbose\x18\x11 \x01(\x08\"E\n\x04Word\x12\r\n\x05start\x18\x01 \x01(\x02\x12\x0b\n\x03\x65nd\x18\x02 \x01(\x02\x12\x0c\n\x04word\x18\x03 \x01(\t\x12\x13\n\x0bprobability\x18\x04 \x01(\x02\"\xd4\x01\n\x07Segment\x12\n\n\x02id\x18\x01 \x01(\x05\x12\x0c\n\x04seek\x18\x02 \x01(\x05\x12\r\n\x05start\x18\x03 \x01(\x02\x12\x0b\n\x03\x65nd\x18\x04 \x01(\x02\x12\x0c\n\x04text\x18\x05 \x01(\t\x12\x0e\n\x06tokens\x18\x06 \x03(\x05\x12\x13\n\x0btemperature\x18\x07 \x01(\x02\x12\x13\n\x0b\x61vg_logprob\x18\x08 \x01(\x02\x12\x19\n\x11\x63ompression_ratio\x18\t \x01(\x02\x12\x16\n\x0eno_speech_prob\x18\n \x01(\x02\x12\x18\n\x05words\x18\x0b \x03(\x0b\x32\t.fwt.Word\"q\n\x11TranscriptionInfo\x12\x10\n\x08language\x18\x01 \x01(\t\x12\x1c\n\x14language_probability\x18\x02 \x01(\x02\x12\x10\n\x08\x64uration\x18\x03 \x01(\x02\x12\x1a\n\x12\x64uration_after_vad\x18\x04 \x01(\x02\"h\n\x12TranscribeResponse\x12$\n\x04info\x18\x01 \x01(\x0b\x32\x16.fwt.TranscriptionInfo\x12\x1e\n\x08segments\x18\x02 \x03(\x0b\x32\x0c.fwt.Segment\x12\x0c\n\x04text\x18\x03 \x01(\t\"t\n\x0bStreamEvent\x12&\n\x04info\x18\x01 \x01(\x0b\x32\x16.fwt.TranscriptionInfoH\x00\x12\x1f\n\x07segment\x18\x02 \x01(\x0b\x32\x0c.fwt.SegmentH\x00\x12\x13\n\tdone_text\x18\x03 \x01(\tH\x00\x42\x07\n\x05\x65vent\"\x0f\n\rHealthRequest\"/\n\x0eHealthResponse\x12\x0e\n\x06status\x18\x01 \x01(\t\x12\r\n\x05model\x18\x02 \x01(\t2\xc1\x01\n\rTranscription\x12=\n\nTranscribe\x12\x16.fwt.TranscribeRequest\x1a\x17.fwt.TranscribeResponse\x12>\n\x10TranscribeStream\x12\x16.fwt.TranscribeRequest\x1a\x10.fwt.StreamEvent0\x01\x12\x31\n\x06Health\x12\x12.fwt.HealthRequest\x1a\x13.fwt.HealthResponseb\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'transcription_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _TRANSCRIBEREQUEST._serialized_start=29
  _TRANSCRIBEREQUEST._serialized_end=408
  _WORD._serialized_start=410
  _WORD._serialized_end=479
  _SEGMENT._serialized_start=482
  _SEGMENT._serialized_end=694
  _TRANSCRIPTIONINFO._serialized_start=696
  _TRANSCRIPTIONINFO._serialized_end=809
  _TRANSCRIBERESPONSE._serialized_start=811
  _TRANSCRIBERESPONSE._serialized_end=915
  _STREAMEVENT._serialized_start=917
  _STREAMEVENT._serialized_end=1033
  _HEALTHREQUEST._serialized_start=1035
  _HEALTHREQUEST._serialized_end=1050
  _HEALTHRESPONSE._serialized_start=1052
  _HEALTHRESPONSE._serialized_end=1099
  _TRANSCRIPTION._serialized_start=1102
  _TRANSCRIPTION._serialized_end=1295
# @@protoc_insertion_point(module_scope)
