"""Image preprocessing (transforms.py)."""
