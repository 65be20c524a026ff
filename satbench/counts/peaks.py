"""Published peaks of the card (NVIDIA's data sheets, dense rates, at the
full power limit): memory bytes/s and float32 (non-tensor-core) FLOP/s.
Copied from chip_smoke.py::card_peaks."""

from __future__ import annotations


def card_peaks(name: str) -> dict:
    if "PCIe" in name:
        return {"bytes_s": 2.0e12, "f32_s": 51.2e12, "part": "H100 PCIe"}
    if "NVL" in name:
        return {"bytes_s": 3.9e12, "f32_s": 60.0e12, "part": "H100 NVL"}
    return {"bytes_s": 3.35e12, "f32_s": 66.9e12, "part": "H100 SXM"}
