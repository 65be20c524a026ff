"""BERT data-prep CLI of the port: the BERT caption files of a Karpathy
split.

    python -m sat_tpu_torch.generate_json_data_bert --split-path \
        dataset.json --data-path data/flickr8k --vocab-file vocab.txt \
        [--max-captions 5] [--max-caption-length 30]

The flags are generate_json_data_bert.py's. It writes
`{train,val,test}_captions_bert.json` into --data-path, each row
`[CLS] + ids + [PAD]* + [SEP]` (data/bert_prep.py). --vocab-file, a local
bert-base-uncased `vocab.txt`, is required: without it the run raises,
naming the flag, where sat_tpu would download the tokenizer. Host only: no
device.
"""

from __future__ import annotations

import argparse

from sat_tpu_torch.data.bert_prep import generate_json_data_bert


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Generate json caption files for BERT tokenization")
    parser.add_argument("--split-path", type=str,
                        default="data/coco/dataset.json")
    parser.add_argument("--data-path", type=str, default="data/coco")
    parser.add_argument("--max-captions", type=int, default=5,
                        help="maximum number of captions per image")
    parser.add_argument("--max-caption-length", type=int, default=30,
                        help="maximum number of tokens in a caption")
    parser.add_argument("--vocab-file", type=str, default=None,
                        help="local bert-base-uncased vocab.txt (required: "
                             "the port downloads nothing)")
    return parser


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    return generate_json_data_bert(args.split_path, args.data_path,
                                   args.max_captions,
                                   args.max_caption_length,
                                   vocab_file=args.vocab_file)


if __name__ == "__main__":
    main()
