from . import migration  # noqa: F401
from .gateway import (  # noqa: F401
    GatewayRouter, GenerationRpcServer, LocalReplica, RemoteReplica,
    ReplicaLost)
from .generation_server import GenerationServer, GenerationStream  # noqa: F401
from .migration import (  # noqa: F401
    MigrationUnsupported, export_sequence, import_sequence)
from .prefix_cache import PrefixCache  # noqa: F401
from .serving import (  # noqa: F401
    RequestTimeout, ServeError, ServerClosed, ServerDraining,
    ServerOverloaded)

__all__ = ["GenerationServer", "GenerationStream", "PrefixCache",
           "MigrationUnsupported", "export_sequence", "import_sequence",
           "GatewayRouter", "LocalReplica", "RemoteReplica",
           "GenerationRpcServer", "ReplicaLost",
           "ServeError", "ServerOverloaded", "ServerClosed",
           "ServerDraining", "RequestTimeout"]
