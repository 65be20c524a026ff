"""Experiment runner of the port: train.py's canned experiments.

    python -m sat_tpu_torch.train_models [name ...]

Port of train_models.py (the reference's sweep, reference
train_models.py:3-163): each experiment is a list of train.py flags,
run in turn as `python -m sat_tpu_torch.train <flags>` in a fresh
process, from the current directory (the flags name `data/flickr8k`). With
no name it runs the four headline Flickr8k experiments; an unknown name
exits with code 2 before anything runs. A failed experiment is reported
and the next one runs.
"""

from __future__ import annotations

import subprocess
import sys

EXPERIMENTS = {
    # The four headline Flickr8k configs (reference train_models.py:15-57).
    "plain-att": ["--data=data/flickr8k", "--epochs=8", "--tf", "--ado",
                  "--attention"],
    "plain-noatt": ["--data=data/flickr8k", "--epochs=8", "--tf", "--ado"],
    "bert-att": ["--data=data/flickr8k", "--epochs=8", "--tf", "--ado",
                 "--attention", "--bert"],
    "bert-noatt": ["--data=data/flickr8k", "--epochs=8", "--tf", "--ado",
                   "--bert"],
    # Smoke config (README.md:51 quick-run flags).
    "smoke": ["--data=data/flickr8k", "--epochs=1", "--frac=0.02",
              "--log-interval=2", "--tf", "--ado", "--attention"],
    # Sweep templates (reference train_models.py:59-135 runs batch/lr sweeps
    # and fine-tune-from-checkpoint variants of the headline configs).
    "plain-att-bs32": ["--data=data/flickr8k", "--epochs=8", "--tf", "--ado",
                       "--attention", "--batch-size=32"],
    "plain-att-bs128": ["--data=data/flickr8k", "--epochs=8", "--tf", "--ado",
                        "--attention", "--batch-size=128"],
    "plain-att-lr3e4": ["--data=data/flickr8k", "--epochs=8", "--tf", "--ado",
                        "--attention", "--lr=3e-4"],
    "plain-att-finetune": ["--data=data/flickr8k", "--epochs=4", "--tf",
                           "--ado", "--attention",
                           "--model=model/model_vgg19_8.npz"],
    "resnet-att": ["--data=data/flickr8k", "--epochs=8", "--tf", "--ado",
                   "--attention", "--network=resnet152"],
    # The headline config from the device feature bank in K-step blocks:
    # the same numbers as per-batch --cache-features training, bit for bit.
    "plain-att-fast": ["--data=data/flickr8k", "--epochs=8", "--tf",
                       "--ado", "--attention", "--cache-features",
                       "--steps-per-dispatch=8"],
}

HEADLINE = ["plain-att", "plain-noatt", "bert-att", "bert-noatt"]


def run_experiment(flags) -> int:
    command = [sys.executable, "-m", "sat_tpu_torch.train"] + list(flags)
    print("Running:", " ".join(command), flush=True)
    code = subprocess.run(command).returncode
    if code != 0:
        print(f"Experiment failed with code {code}", flush=True)
    return code


def main(argv=None) -> None:
    names = (sys.argv[1:] if argv is None else list(argv)) or HEADLINE
    for name in names:
        if name not in EXPERIMENTS:
            print(f"Unknown experiment '{name}'. Known: {sorted(EXPERIMENTS)}")
            sys.exit(2)
    for name in names:
        run_experiment(EXPERIMENTS[name])


if __name__ == "__main__":
    main()
