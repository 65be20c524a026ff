"""Special-token constants, copied from sat_tpu/constants.py.

Vanilla vocabulary ids match the reference's offline prep: the word dict is
built with `<start>=0, <eos>=1, <unk>=2, <pad>=3`. BERT ids are the fixed
`bert-base-uncased` vocabulary ids.
"""

# Vanilla word_dict special tokens
START = 0
EOS = 1
UNK = 2
PAD = 3

# bert-base-uncased special token ids
BERT_PAD = 0
BERT_CLS = 101
BERT_SEP = 102
BERT_VOCAB_SIZE = 30522
BERT_HIDDEN_SIZE = 768

# Beam-search completion sets (the reference's sentence terminators):
#  - vanilla: next_word in {1, 102}  (<eos>, plus the stray 102 kept verbatim)
#  - bert:    next_word in {1, 0}
BEAM_STOP_VANILLA = (1, 102)
BEAM_STOP_BERT = (1, 0)

# Hard cap on beam-search steps: the reference's loop runs its body once
# more after step == 50 before breaking, i.e. at most 51 expansion steps.
BEAM_MAX_STEPS = 51

# Caption token budget used by data prep.
MAX_CAPTION_LENGTH = 25

# ImageNet normalization used by every encoder.
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
IMAGE_SIZE = 224
