"""gRPC plumbing for the three-party protocol — counterpart of
``hhe_tpu.parties.rpc``, unchanged.

The environment ships ``grpcio`` but not the Python service codegen plugin,
so services are registered through grpc's generic-handler API with message
classes generated by ``protoc --python_out`` (``gen/hhe_pb2.py``, a
byte-for-byte copy of the JAX package's: both register ``hhe.proto`` in
protobuf's default descriptor pool, which takes the same file twice but not
two different ones).  Wire-compatible with the reference services
(``protos/hhe.proto``, reference ``src/gen_code/hhe.grpc.pb.h``).  Message
lengths are unlimited: an analyst's key set at N=16384 / 13 limbs is
~1.27 GB, under protobuf's 2 GiB cap.
"""

from __future__ import annotations

import concurrent.futures
from typing import Callable, Dict, Tuple

import grpc

from .gen import hhe_pb2 as pb

ANALYST_SERVICE = "hheproto.AnalystService"
CSP_SERVICE = "hheproto.CSPService"

# method -> (request class, response class)
ANALYST_METHODS = {
    "getPublicKey": (pb.Empty, pb.PublicKeyMsg),
    "addEncryptedResult": (pb.CiphertextResult, pb.Empty),
}
CSP_METHODS = {
    "addPublicKeys": (pb.PublicKeySetMsg, pb.Empty),
    "addEncryptedKeys": (pb.EncSymmetricKeysMsg, pb.Empty),
    "addEncryptedData": (pb.EncSymmetricDataMsg, pb.Empty),
    "addMLModel": (pb.MLModelMsg, pb.Empty),
    "evaluateModel": (pb.CiphertextBytes, pb.Empty),
    "evaluateModelFromFile": (pb.DataFile, pb.Empty),
}

_UNLIMITED = [
    ("grpc.max_send_message_length", -1),
    ("grpc.max_receive_message_length", -1),
]


def _typed_errors(handler: Callable) -> Callable:
    """Map handler failures to typed gRPC statuses instead of UNKNOWN
    (reference CSPRPC.cpp:241-244 returns Status(DATA_LOSS, msg) on bad
    payloads; missing checkpoint files map to NOT_FOUND)."""

    import struct

    def wrapped(request, context):
        try:
            return handler(request, context)
        except FileNotFoundError as e:
            context.abort(grpc.StatusCode.NOT_FOUND, f"missing file: {e}")
        except (
            ValueError,
            KeyError,
            IndexError,
            AssertionError,
            TypeError,
            struct.error,
        ) as e:
            context.abort(
                grpc.StatusCode.DATA_LOSS,
                f"Error deserializing/processing the message: {e}",
            )

    return wrapped


def serve(
    address: str,
    service_name: str,
    methods: Dict[str, Tuple],
    handlers: Dict[str, Callable],
    max_workers: int = 4,
) -> grpc.Server:
    """Start an insecure server exposing `handlers[m](request, context)`."""
    rpc_handlers = {}
    for m, (req_cls, resp_cls) in methods.items():
        rpc_handlers[m] = grpc.unary_unary_rpc_method_handler(
            _typed_errors(handlers[m]),
            request_deserializer=req_cls.FromString,
            response_serializer=resp_cls.SerializeToString,
        )
    server = grpc.server(
        concurrent.futures.ThreadPoolExecutor(max_workers=max_workers),
        options=_UNLIMITED,
    )
    server.add_generic_rpc_handlers(
        (grpc.method_handlers_generic_handler(service_name, rpc_handlers),)
    )
    server.add_insecure_port(address)
    server.start()
    return server


class Client:
    """Typed unary-unary client for one service."""

    def __init__(self, address: str, service_name: str, methods: Dict[str, Tuple]):
        self.channel = grpc.insecure_channel(address, options=_UNLIMITED)
        self._calls = {
            m: self.channel.unary_unary(
                f"/{service_name}/{m}",
                request_serializer=req.SerializeToString,
                response_deserializer=resp.FromString,
            )
            for m, (req, resp) in methods.items()
        }

    def call(self, method: str, request, metadata=None):
        return self._calls[method](request, metadata=metadata)

    def close(self):
        self.channel.close()


def analyst_client(address: str) -> Client:
    return Client(address, ANALYST_SERVICE, ANALYST_METHODS)


def csp_client(address: str) -> Client:
    return Client(address, CSP_SERVICE, CSP_METHODS)
