"""Export a decoder checkpoint as a `.pth` that the reference loads.

Port of tools/export_reference_pth.py: takes a per-epoch
`model_<network>_<epoch>.npz` (written by training, sat_tpu's or the
port's) and writes the torch state_dict that the reference's
`decoder.load_state_dict(torch.load(path))` accepts, with the keys, shapes
and bits that the tool writes (compat/torch_decoder.py's
`state_dict_from_decoder_params`).

    python -m sat_tpu_torch.export_reference_pth \\
        --model model/model_vgg19_8.npz --out model_vgg19_8.pth

No model config is needed: the archive's `/`-joined names carry the
structure, the `ado` head included.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from sat_tpu_torch.compat.torch_decoder import state_dict_from_decoder_params


def export_reference_pth(model_path: str, out_path: str) -> int:
    """Write `model_path`'s decoder to `out_path`; the tensors written."""
    with np.load(model_path) as data:
        params = {k: data[k] for k in data.files}
    sd = state_dict_from_decoder_params(params)
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, out_path)
    return len(sd)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--model", type=str, required=True,
                        help="decoder checkpoint (.npz)")
    parser.add_argument("--out", type=str, required=True,
                        help="output torch state_dict (.pth)")
    args = parser.parse_args(argv)
    n = export_reference_pth(args.model, args.out)
    print(f"wrote {args.out} ({n} tensors)")


if __name__ == "__main__":
    main()
