"""Corpus schema, query/gallery split, ground truth, synthetic corpus,
graph build, the CLIP BPE tokenizer and text features."""

from .bpe import ClipBPETokenizer, load_clip_bpe  # noqa: F401
