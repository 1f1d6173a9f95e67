"""Runtime loops of the port: the wave-batching server
(:mod:`.serve_loop`)."""
