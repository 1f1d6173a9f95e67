"""Runtime loops of the port: the wave-batching server
(:mod:`.serve_loop`) and the fault-tolerant training loop
(:mod:`.train_loop`)."""
