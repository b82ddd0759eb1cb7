"""Layers of the port: parameter specs, norms and embeddings, and the
RWKV6 time- and channel-mix blocks over the scan engine."""
