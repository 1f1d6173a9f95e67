"""Dense decoder of the port (slot-cache serving path)."""
