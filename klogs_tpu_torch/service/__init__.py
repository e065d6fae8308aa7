"""The remote filter service of the port: filterd and its client.

Counterpart of ``klogs_tpu/service``, for one endpoint: the gRPC wire
protocol (``transport.py``, byte for byte the JAX package's), the
server that owns the card (``server.py``; ``python -m
klogs_tpu_torch.service``) and the collector's client (``client.py``;
``--remote HOST:PORT``). The sharded client, the resolver and the
multi-tenant registry (``--remote`` lists, ``--shard-mode``,
``--resolver``, ``--multi-set``) are not ported yet.
"""
