"""The training and evaluation steps (one device)."""
