"""Model code of the port: config, layers, KV caches, attention, decoder."""
