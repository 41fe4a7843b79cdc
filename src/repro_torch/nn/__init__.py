"""Layers: initialisers, norms, embedding and head, RWKV6 mixing."""
