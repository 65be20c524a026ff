"""Image preprocessing (transforms.py), caption dataset and batch loader
(dataset.py)."""
