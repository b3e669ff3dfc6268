"""Text node features: CPC definitions and patent titles → embeddings (port
of patent_tpu/data/text_features.py; graph generation cells 12-15).

The encoder is the port's ``TextTransformer``.  Tokens come from the
checkpoint's CLIP BPE (``data/bpe.py``) when a local checkpoint directory
holds ``vocab.json`` and ``merges.txt``, else from ``CLIPTokenizerFast``
over its ``tokenizer.json`` where ``transformers`` is installed, else from
a deterministic hashing tokenizer, whose ids equal the JAX package's.  The
features feed ``data/graph_build.build_feature_matrix``: titles to the
patent rows, definitions to the CPC rows.
"""

from __future__ import annotations

import hashlib
import re
from typing import Callable, Mapping, Sequence

import numpy as np
import torch

from ..models.vit import TEXT_B, TextConfig, TextTransformer


def hashing_tokenizer(vocab_size: int = 49408, context_length: int = 77
                      ) -> Callable[[str], np.ndarray]:
    """Deterministic word-hash tokenizer: id = BLAKE2s(word) mod (vocab−3)
    + 2, with 1 as BOS and the largest id, vocab−1, at the EOS slot (the
    text tower pools at the argmax id); zeros pad the row."""

    def tokenize(text: str) -> np.ndarray:
        words = re.findall(r"[a-z0-9]+", text.lower())[: context_length - 2]
        ids = [1]
        for w in words:
            h = int.from_bytes(hashlib.blake2s(w.encode()).digest()[:4], "big")
            ids.append(2 + h % (vocab_size - 3))
        ids.append(vocab_size - 1)
        out = np.zeros(context_length, np.int32)
        out[:len(ids)] = ids[:context_length]
        return out

    return tokenize


def clip_tokenizer_or_fallback(checkpoint_dir: str | None,
                               config: TextConfig = TEXT_B):
    """The tokenizer of a local checkpoint directory, in this order of
    preference: the port's CLIP BPE over its vocab.json + merges.txt,
    ``CLIPTokenizerFast`` over its tokenizer.json (imported here, where
    ``transformers`` may be missing), the hashing tokenizer."""
    if checkpoint_dir:
        from .bpe import load_clip_bpe

        bpe = load_clip_bpe(checkpoint_dir, config.context_length)
        if bpe is not None:
            return bpe
        try:
            from transformers import CLIPTokenizerFast

            tok = CLIPTokenizerFast.from_pretrained(checkpoint_dir)

            def tokenize(text: str) -> np.ndarray:
                ids = tok(text, padding="max_length", truncation=True,
                          max_length=config.context_length)["input_ids"]
                return np.asarray(ids, np.int32)

            return tokenize
        except Exception:
            # no transformers, or no tokenizer files (an ImportError, or by
            # version an OSError, ValueError or TypeError): the fallback
            pass
    return hashing_tokenizer(config.vocab_size, config.context_length)


def embed_texts(texts: Sequence[str], model: TextTransformer,
                tokenize: Callable[[str], np.ndarray],
                batch_size: int = 256) -> np.ndarray:
    """The text tower over ``texts`` in batches, on the model's device →
    [n, projection_dim] f32 numpy.  The last batch is padded with zero rows
    to ``batch_size``, as the JAX function pads it."""
    device = model.token_embedding.device
    ids = np.stack([tokenize(t) for t in texts]) if texts else \
        np.zeros((0, model.config.context_length), np.int32)
    out = []
    with torch.inference_mode():
        for s in range(0, len(ids), batch_size):
            chunk = ids[s:s + batch_size]
            pad = batch_size - len(chunk)
            if pad:
                chunk = np.pad(chunk, ((0, pad), (0, 0)))
            feats = model(torch.from_numpy(chunk).to(device))
            out.append(feats[:batch_size - pad].float().cpu().numpy())
    return np.concatenate(out, axis=0) if out else np.zeros((0, 0), np.float32)


def build_text_feature_dicts(
    cpc_definitions: Mapping[str, str],
    patent_titles: Mapping[str, str] | None = None,
    model: TextTransformer | None = None,
    checkpoint_dir: str | None = None,
    seed: int = 0,
    device: torch.device | str | None = None,
) -> tuple[dict[str, np.ndarray], dict[str, np.ndarray]]:
    """(cpc_features, patent_features), keyed like the graph's index maps.

    ``cpc_definitions``: CPC code → definition text (any level);
    ``patent_titles``: patent id → title.  ``model`` (moved to ``device``)
    defaults to a ``TextTransformer(TEXT_B)`` drawn from ``seed``, whose
    features are consistent but untrained; load CLIP's weights into one
    (``clip_import.load_hf_clip_text_params``) for meaningful features.
    ``device``: the card unless given (an error where there is none)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("build_text_feature_dicts: no CUDA card is "
                               "visible; pass device='cpu' to run on the CPU")
        device = "cuda"
    if model is None:
        model = TextTransformer(
            TEXT_B, generator=torch.Generator().manual_seed(seed))
    model = model.to(device).eval()
    tokenize = clip_tokenizer_or_fallback(checkpoint_dir, model.config)
    cpc_keys = sorted(cpc_definitions)
    cpc_emb = embed_texts([cpc_definitions[k] for k in cpc_keys], model,
                          tokenize)
    cpc_features = {k: cpc_emb[i] for i, k in enumerate(cpc_keys)}
    patent_features: dict[str, np.ndarray] = {}
    if patent_titles:
        keys = sorted(patent_titles)
        emb = embed_texts([patent_titles[k] for k in keys], model, tokenize)
        patent_features = {k: emb[i] for i, k in enumerate(keys)}
    return cpc_features, patent_features


def parse_cpc_definitions_fixed_width(lines: Sequence[str]) -> dict[str, str]:
    """USPTO fixed-width CPC title lines 'A01B    3/14    Title…' → {code:
    title}, the first title of each class or subclass code (graph
    generation cell 10's other parser); blank and '#' lines skipped."""
    out: dict[str, str] = {}
    for line in lines:
        line = line.rstrip("\n")
        if not line or line.startswith("#"):
            continue
        m = re.match(r"^([A-Z]\d{2}[A-Z]?)\s+(?:[\d/]+\s+)?(.+)$", line)
        if m:
            code, title = m.group(1), m.group(2).strip()
            out.setdefault(code, title)
    return out
