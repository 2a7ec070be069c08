"""Weight carry-over into the port."""
