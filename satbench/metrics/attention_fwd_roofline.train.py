"""The attention forward kernel against its bound in the train step, R =
1, in % (satbench/readers.py::attention_fwd_roofline)."""

from satbench.readers import attention_fwd_roofline as read  # noqa: F401
