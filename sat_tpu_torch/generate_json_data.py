"""Data-prep CLI of the port: the vocabulary and caption files of a
Karpathy split.

    python -m sat_tpu_torch.generate_json_data --split-path dataset.json \
        --data-path data/flickr8k [--max-captions 5] [--min-word-count 5] \
        [--max-caption-length 25]

The flags are generate_json_data.py's (the reference's surface). It writes
`word_dict.json` and `{train,val,test}_{img_paths,captions}.json` into
--data-path, the image paths under `<data-path>/imgs/`
(data/vocab.py::generate_json_data). Host only: no device.
"""

from __future__ import annotations

import argparse

from sat_tpu_torch.data.vocab import generate_json_data


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Generate json files")
    parser.add_argument("--split-path", type=str,
                        default="data/coco/dataset.json")
    parser.add_argument("--data-path", type=str, default="data/coco")
    parser.add_argument("--max-captions", type=int, default=5,
                        help="maximum number of captions per image")
    parser.add_argument("--min-word-count", type=int, default=5,
                        help="minimum number of occurences of a word to be "
                             "included in word dictionary")
    parser.add_argument("--max-caption-length", type=int, default=25,
                        help="maximum number of tokens in a caption")
    return parser


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    return generate_json_data(args.split_path, args.data_path,
                              args.max_captions, args.min_word_count,
                              args.max_caption_length)


if __name__ == "__main__":
    main()
