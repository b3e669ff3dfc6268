"""CLIP byte-level BPE tokenizer (the port's copy of
patent_tpu/data/bpe.py).

Lowercase and whitespace normalization, the CLIP token pattern, the
byte-to-unicode table, ranked BPE merges with the ``</w>`` end-of-word
marker, and ``<|startoftext|>`` / ``<|endoftext|>`` framing, read from an
HF-style checkpoint's ``vocab.json`` + ``merges.txt``; the same ids as
``transformers.CLIPTokenizer`` over the same files.  The exact pattern
needs the ``regex`` package's Unicode property classes; where that package
is missing the ``re`` pattern below stands in (``_re.__name__`` says which
ran): it splits ASCII text alike but drops underscores.  CLIP's reference
also repairs mojibake with ``ftfy``; here text is only HTML-unescaped.
"""

from __future__ import annotations

import functools
import html
import json
import os

import numpy as np

try:                                    # exact CLIP pattern needs \p classes
    import regex as _re
    _PAT = _re.compile(
        r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|"""
        r"""[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+""", _re.IGNORECASE)
except Exception:  # pragma: no cover — regex ships with transformers
    import re as _re
    _PAT = _re.compile(
        r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|"""
        r"""[^\W\d_]+|\d|[^\s\w]+""", _re.IGNORECASE)


@functools.lru_cache()
def _bytes_to_unicode() -> dict[int, str]:
    """GPT-2/CLIP printable-unicode byte remapping (exact table)."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _basic_clean(text: str) -> str:
    return html.unescape(html.unescape(text)).strip()


def _whitespace_clean(text: str) -> str:
    return " ".join(text.split())


def _get_pairs(word: tuple[str, ...]) -> set[tuple[str, str]]:
    return set(zip(word[:-1], word[1:]))


class ClipBPETokenizer:
    """CLIP BPE over a local ``vocab.json`` + ``merges.txt``.

    ``encode`` returns raw BPE ids (no framing); ``__call__`` returns the
    fixed-length [context_length] id row the text tower consumes: SOT +
    ids + EOT, truncated so EOT always survives, padded with EOT (the HF
    CLIP pad token) — under causal attention the EOT position's features
    see only the prefix, so padding content never leaks into the pooled
    feature (models/vit.py TextTransformer pools at argmax(ids)).
    """

    def __init__(self, vocab_file: str, merges_file: str,
                 context_length: int = 77):
        with open(vocab_file, encoding="utf-8") as f:
            self.encoder: dict[str, int] = json.load(f)
        with open(merges_file, encoding="utf-8") as f:
            lines = f.read().strip().split("\n")
        # EXACTLY HF CLIPTokenizer's slice: strip, drop line 0
        # unconditionally (the "#version" header slot), cap at
        # 49152-256-2 entries.  Filtering instead of slicing diverges on
        # nonstandard exports (a real merge on line 0, or blank lines
        # mid-file, which HF keeps as rank slots) and would silently shift
        # every BPE rank.
        merges = [tuple(m.split())
                  for m in lines[1:49152 - 256 - 2 + 1]]
        self.bpe_ranks = dict(zip(merges, range(len(merges))))
        self.byte_encoder = _bytes_to_unicode()
        self.context_length = context_length
        self.sot = self.encoder["<|startoftext|>"]
        self.eot = self.encoder["<|endoftext|>"]
        self._cache: dict[str, list[str]] = {}

    def _bpe(self, token: str) -> list[str]:
        if token in self._cache:
            return self._cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = _get_pairs(word)
        if not pairs:
            return [token + "</w>"]
        while True:
            bigram = min(pairs,
                         key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word: list[str] = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if (i < len(word) - 1 and word[i] == first
                        and word[i + 1] == second):
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = _get_pairs(word)
        out = list(word)
        self._cache[token] = out
        return out

    def encode(self, text: str) -> list[int]:
        text = _whitespace_clean(_basic_clean(text)).lower()
        ids: list[int] = []
        for token in _PAT.findall(text):
            token = "".join(self.byte_encoder[b]
                            for b in token.encode("utf-8"))
            # OOV → EOT id, matching HF's unk_token="<|endoftext|>" (only
            # reachable with partial vocabularies; the real CLIP vocab
            # covers every byte)
            ids.extend(self.encoder.get(t, self.eot)
                       for t in self._bpe(token))
        return ids

    def __call__(self, text: str) -> np.ndarray:
        ids = self.encode(text)[:self.context_length - 2]
        row = [self.sot] + ids + [self.eot]
        row += [self.eot] * (self.context_length - len(row))
        return np.asarray(row, np.int32)


def load_clip_bpe(checkpoint_dir: str,
                  context_length: int = 77) -> ClipBPETokenizer | None:
    """ClipBPETokenizer from an HF-style checkpoint dir, or None if the
    vocab/merges files are absent."""
    vocab = os.path.join(checkpoint_dir, "vocab.json")
    merges = os.path.join(checkpoint_dir, "merges.txt")
    if os.path.isfile(vocab) and os.path.isfile(merges):
        return ClipBPETokenizer(vocab, merges, context_length)
    return None
