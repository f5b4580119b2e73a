# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: hhe.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\thhe.proto\x12\x08hheproto\"7\n\x0f\x43iphertextBytes\x12\x11\n\tHHEDecomp\x18\x01 \x03(\x0c\x12\x11\n\tanalystID\x18\x02 \x01(\t\"\x07\n\x05\x45mpty\",\n\x0cPublicKeyMsg\x12\x0c\n\x04\x64\x61ta\x18\x01 \x01(\x0c\x12\x0e\n\x06length\x18\x02 \x01(\x05\"\xe2\x01\n\x0fPublicKeySetMsg\x12\"\n\x02pk\x18\x01 \x01(\x0b\x32\x16.hheproto.PublicKeyMsg\x12\"\n\x02rk\x18\x02 \x01(\x0b\x32\x16.hheproto.PublicKeyMsg\x12\"\n\x02gk\x18\x03 \x01(\x0b\x32\x16.hheproto.PublicKeyMsg\x12&\n\x06\x63sp_rk\x18\x04 \x01(\x0b\x32\x16.hheproto.PublicKeyMsg\x12&\n\x06\x63sp_gk\x18\x05 \x01(\x0b\x32\x16.hheproto.PublicKeyMsg\x12\x13\n\x0b\x61nalystUUID\x18\x06 \x01(\t\";\n\x10\x43iphertextResult\x12\'\n\x06result\x18\x01 \x03(\x0b\x32\x17.hheproto.CiphertextMsg\"-\n\rCiphertextMsg\x12\x0c\n\x04\x64\x61ta\x18\x01 \x01(\x0c\x12\x0e\n\x06length\x18\x02 \x01(\x05\"6\n\nMLModelMsg\x12(\n\x07weights\x18\x01 \x03(\x0b\x32\x17.hheproto.CiphertextMsg\";\n\x13\x45ncSymmetricKeysMsg\x12$\n\x03key\x18\x01 \x03(\x0b\x32\x17.hheproto.CiphertextMsg\"Z\n\x13\x45ncSymmetricDataMsg\x12\x30\n\x06record\x18\x01 \x03(\x0b\x32 .hheproto.EncSymmetricDataRecord\x12\x11\n\tpatientID\x18\x02 \x01(\t\"\'\n\x16\x45ncSymmetricDataRecord\x12\r\n\x05value\x18\x01 \x03(\x04\"\x1c\n\x08\x44\x61taFile\x12\x10\n\x08\x66ilename\x18\x01 \x01(\t2\x90\x01\n\x0e\x41nalystService\x12\x39\n\x0cgetPublicKey\x12\x0f.hheproto.Empty\x1a\x16.hheproto.PublicKeyMsg\"\x00\x12\x43\n\x12\x61\x64\x64\x45ncryptedResult\x12\x1a.hheproto.CiphertextResult\x1a\x0f.hheproto.Empty\"\x00\x32\x8d\x03\n\nCSPService\x12=\n\raddPublicKeys\x12\x19.hheproto.PublicKeySetMsg\x1a\x0f.hheproto.Empty\"\x00\x12\x44\n\x10\x61\x64\x64\x45ncryptedKeys\x12\x1d.hheproto.EncSymmetricKeysMsg\x1a\x0f.hheproto.Empty\"\x00\x12\x44\n\x10\x61\x64\x64\x45ncryptedData\x12\x1d.hheproto.EncSymmetricDataMsg\x1a\x0f.hheproto.Empty\"\x00\x12\x35\n\naddMLModel\x12\x14.hheproto.MLModelMsg\x1a\x0f.hheproto.Empty\"\x00\x12=\n\revaluateModel\x12\x19.hheproto.CiphertextBytes\x1a\x0f.hheproto.Empty\"\x00\x12>\n\x15\x65valuateModelFromFile\x12\x12.hheproto.DataFile\x1a\x0f.hheproto.Empty\"\x00\x42\x06\xa2\x02\x03HHEb\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'hhe_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  DESCRIPTOR._serialized_options = b'\242\002\003HHE'
  _CIPHERTEXTBYTES._serialized_start=23
  _CIPHERTEXTBYTES._serialized_end=78
  _EMPTY._serialized_start=80
  _EMPTY._serialized_end=87
  _PUBLICKEYMSG._serialized_start=89
  _PUBLICKEYMSG._serialized_end=133
  _PUBLICKEYSETMSG._serialized_start=136
  _PUBLICKEYSETMSG._serialized_end=362
  _CIPHERTEXTRESULT._serialized_start=364
  _CIPHERTEXTRESULT._serialized_end=423
  _CIPHERTEXTMSG._serialized_start=425
  _CIPHERTEXTMSG._serialized_end=470
  _MLMODELMSG._serialized_start=472
  _MLMODELMSG._serialized_end=526
  _ENCSYMMETRICKEYSMSG._serialized_start=528
  _ENCSYMMETRICKEYSMSG._serialized_end=587
  _ENCSYMMETRICDATAMSG._serialized_start=589
  _ENCSYMMETRICDATAMSG._serialized_end=679
  _ENCSYMMETRICDATARECORD._serialized_start=681
  _ENCSYMMETRICDATARECORD._serialized_end=720
  _DATAFILE._serialized_start=722
  _DATAFILE._serialized_end=750
  _ANALYSTSERVICE._serialized_start=753
  _ANALYSTSERVICE._serialized_end=897
  _CSPSERVICE._serialized_start=900
  _CSPSERVICE._serialized_end=1297
# @@protoc_insertion_point(module_scope)
