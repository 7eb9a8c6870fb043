"""Dataset -> benchmark registry.

Counterpart of million_tpu/benchmarks/registry.py, copied so that the port
imports nothing of the reference package. Dataset names map to benchmark
kinds (`select_benchmark`), and token streams load through `load_tokens`: HF
datasets when installed and cached (wikitext-2/103, ptb), a local text or
.npy token file, or the `_synthetic` random stream, drawn with numpy from the
seed so that both packages see the same tokens. `transformers` and `datasets`
are optional imports that raise a clear error when missing.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional

import numpy as np

PPL_DATASETS = {"wikitext-2", "wikitext-103", "ptb"}


class ByteTokenizer:
    """Hermetic byte-level tokenizer: ids are UTF-8 bytes (vocab 256).

    Stands in for an HF tokenizer in offline/synthetic runs (the registry
    analogue of the reference's `_synthetic` escape hatch) so that the
    text-driven harnesses — LongBench, lm-eval, .txt perplexity — run
    end-to-end without model assets. Matches the two HF calls the harnesses
    use: `tok(text) -> {"input_ids": [...]}` and `tok.decode(ids) -> text`.
    """

    vocab_size = 256

    def __call__(self, text: str, add_special_tokens: bool = True):
        return {"input_ids": list(text.encode("utf-8"))}

    def decode(self, ids) -> str:
        return bytes(int(i) % 256 for i in ids).decode("utf-8", errors="replace")


def load_tokenizer(spec: Optional[str]):
    """spec: None/"byte" -> ByteTokenizer; anything else -> HF AutoTokenizer
    path or hub name (assets must be local)."""
    if spec in (None, "", "byte"):
        return ByteTokenizer()
    try:
        from transformers import AutoTokenizer  # type: ignore
    except ImportError as e:
        raise RuntimeError(
            f"tokenizer {spec!r} needs the `transformers` package; "
            f"model.tokenizer=byte runs without it"
        ) from e

    return AutoTokenizer.from_pretrained(spec)
_HF_SPECS = {
    "wikitext-2": ("wikitext", "wikitext-2-raw-v1", "test", "text"),
    "wikitext-103": ("wikitext", "wikitext-103-raw-v1", "test", "text"),
    "ptb": ("ptb_text_only", "penn_treebank", "test", "sentence"),
}


def load_tokens(
    dataset: str,
    tokenizer=None,
    vocab_size: int = 32000,
    synthetic_len: int = 1 << 16,
    seed: int = 0,
) -> np.ndarray:
    """Return a 1-D int32 token stream for a ppl dataset name, a local file
    path (.txt tokenized by `tokenizer`, .npy raw token ids), or
    '_synthetic' (random ids)."""
    if dataset == "_synthetic":
        rng = np.random.default_rng(seed)
        return rng.integers(0, vocab_size, synthetic_len).astype(np.int32)
    p = Path(dataset)
    if p.suffix == ".npy" and p.exists():
        return np.load(p).astype(np.int32).reshape(-1)
    if p.exists():
        if tokenizer is None:
            raise ValueError(f"need a tokenizer to tokenize text file {dataset}")
        ids = np.asarray(tokenizer(p.read_text())["input_ids"], np.int32)
        # a mismatched tokenizer (e.g. the hermetic byte fallback on a tiny
        # test vocab) must not index the embedding out of range
        return ids % vocab_size
    if dataset in _HF_SPECS:
        if tokenizer is None:
            raise ValueError(f"need a tokenizer for dataset {dataset}")
        try:
            from datasets import load_dataset  # type: ignore
        except ImportError as e:
            raise RuntimeError(
                f"dataset {dataset!r} needs the `datasets` package (offline "
                f"environments: pass a local .txt/.npy path instead)"
            ) from e
        name, config, split, field = _HF_SPECS[dataset]
        ds = load_dataset(name, config, split=split)
        text = "\n\n".join(r[field] for r in ds)
        # same out-of-range guard as the .txt path: a tokenizer/model vocab
        # mismatch must not index the embedding out of range
        return np.asarray(tokenizer(text)["input_ids"], np.int32) % vocab_size
    raise ValueError(f"unknown dataset {dataset!r}")


def select_benchmark(dataset: str) -> str:
    """Name -> benchmark kind (reference select_benchmark,
    benchmarks/__init__.py:3-17)."""
    if dataset in PPL_DATASETS or Path(dataset).suffix in (".npy", ".txt"):
        return "perplexity"
    if dataset == "_synthetic":
        return "speedtest"
    if dataset.startswith("longbench:"):
        return "longbench"
    if dataset.startswith("lm_eval:"):
        return "lm_eval"
    return "perplexity"
