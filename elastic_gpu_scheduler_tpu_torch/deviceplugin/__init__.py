"""The node plane of an NVIDIA GPU node: the kubelet device plugin
(``plugin``), its copy of the reference's generated messages
(``deviceplugin_pb2``) and the coordinates it advertises (``topology``).

The only part of the port that imports ``grpc`` and ``google.protobuf``,
and only where its gRPC wiring runs."""
