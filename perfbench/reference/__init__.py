"""The plain reference: PyTorch and numpy only; it imports nothing of
the program."""
