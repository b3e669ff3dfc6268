"""Corpus schema, query/gallery split, ground truth, synthetic corpus."""
