"""Image preprocessing (transforms.py; the native C++ loader, native.py),
caption dataset and batch loader (dataset.py), the data prep of a
Karpathy split (vocab.py, bert_prep.py) and the BERT WordPiece tokenizer
(bert_vocab.py)."""
