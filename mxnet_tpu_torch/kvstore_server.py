"""Server/scheduler role entry point.

Counterpart of ``mxnet_tpu/kvstore_server.py`` (reference:
``python/mxnet/kvstore_server.py:28-75``): in the ps-lite design,
processes launched with ``DMLC_ROLE`` of ``server`` or ``scheduler``
block inside ``KVStoreServer.run()`` serving key/value RPCs until
shutdown.

Here there are no parameter-server processes: ``dist_sync`` is
collectives over ``torch.distributed`` and ``dist_async``'s server is a
thread inside worker 0.  ``run()`` therefore logs and returns, so
launcher scripts that still spawn server processes exit cleanly instead
of hanging, as in the JAX package.
"""
import logging
import os

__all__ = ["KVStoreServer", "_init_kvstore_server_module"]


class KVStoreServer:
    """Reference: kvstore_server.py KVStoreServer."""

    def __init__(self, kvstore=None):
        self.kvstore = kvstore
        self.init_logging = False

    def _controller(self):
        def server_controller(cmd_id, cmd_body):
            if not self.init_logging:
                logging.basicConfig(level=logging.INFO)
                self.init_logging = True
        return server_controller

    def run(self):
        """No parameter server process exists here; return so the
        launcher's server process exits cleanly."""
        logging.getLogger(__name__).info(
            "the collective and dist_async stores run inside the workers; "
            "the %s role has no server loop to run (reference "
            "kvstore_server.py:52 blocked here).",
            os.environ.get("DMLC_ROLE", "server"))


def _init_kvstore_server_module():
    """Reference: kvstore_server.py:77, called at import in the reference
    to take over server and scheduler processes.  Worker and
    single-process roles fall through untouched."""
    role = os.environ.get("DMLC_ROLE", "")
    if role in ("server", "scheduler"):
        server = KVStoreServer()
        server.run()
    return role
