"""The remote filter service of the port: filterd and its clients.

Counterpart of ``klogs_tpu/service``: the gRPC wire protocol
(``transport.py``, byte for byte the JAX package's), the server that
owns the card (``server.py``; ``python -m klogs_tpu_torch.service``,
with ``--multi-set`` the pattern-set registry of ``tenancy.py``), the
collector's client of one endpoint (``client.py``; ``--remote
HOST:PORT``) and of a fleet (``shard.py``; ``--remote`` lists,
``--shard-mode``), and the fleet's live membership (``resolver.py``;
``--resolver``).
"""
