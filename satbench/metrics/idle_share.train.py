"""The device's idle share of the train cell's traced slice, in %
(satbench/readers.py::idle_share)."""

from satbench.readers import idle_share as read  # noqa: F401
