"""The attention forward kernel against its bound in the beam, R = 5 rows
an image, in % (satbench/readers.py::attention_fwd_roofline)."""

from satbench.readers import attention_fwd_roofline as read  # noqa: F401
