"""Dataset / model fetchers: a copy of million_tpu/utils/download.py (pure
Python; the port keeps its own), with the same offline answers.

Every fetcher (a) probes the network first (`have_network`, which opens one
connection to the host it names: tests replace it), (b) uses the `datasets`
/ `huggingface_hub` packages when the network is there, and (c) otherwise
points at the pinned LOCAL fixtures under tests/fixtures, so the real-data
harnesses stay runnable offline; a model cannot be fetched offline and
raises:

    python -m million_tpu_torch.utils.download --dataset wikitext-2
    python -m million_tpu_torch.utils.download --model TinyLlama/TinyLlama-1.1B-Chat-v1.0

Artifacts land under artifacts/datasets/<name>/ as plain .txt (ppl sets)
or .jsonl (LongBench tasks) so the CLI can consume them as local paths
(`run.dataset=<path>.txt`, `run.dataset=longbench:<task>` +
`run.data_path=<path>.jsonl`).
"""

from __future__ import annotations

import argparse
import socket
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
FIXTURES = REPO / "tests" / "fixtures"

PPL_SETS = {
    "wikitext-2": ("wikitext", "wikitext-2-raw-v1", "test", "text"),
    "wikitext-103": ("wikitext", "wikitext-103-raw-v1", "test", "text"),
    "ptb": ("ptb_text_only", "penn_treebank", "test", "sentence"),
}
LONGBENCH_REPO = "THUDM/LongBench"


def have_network(host: str = "huggingface.co", timeout: float = 3.0) -> bool:
    try:
        socket.create_connection((host, 443), timeout=timeout).close()
        return True
    except OSError:
        return False


def fetch_ppl_dataset(name: str, out_dir: Path) -> Path:
    """Download a perplexity dataset split to <out_dir>/<name>.txt, or
    return the pinned local fixture when offline."""
    out = out_dir / f"{name}.txt"
    if out.exists():
        return out
    if not have_network():
        fixture = FIXTURES / "realtext.txt"
        if fixture.exists():
            print(
                f"[download] no network: using pinned fixture {fixture} "
                f"in place of {name}", file=sys.stderr,
            )
            return fixture
        raise RuntimeError(
            f"no network and no cached copy of {name}; pinned fixture "
            f"{fixture} is missing"
        )
    from datasets import load_dataset  # type: ignore

    ds_name, config, split, field = PPL_SETS[name]
    ds = load_dataset(ds_name, config, split=split)
    out_dir.mkdir(parents=True, exist_ok=True)
    out.write_text("\n\n".join(r[field] for r in ds))
    return out


def fetch_longbench_task(task: str, out_dir: Path) -> Path:
    """Download one LongBench task to <out_dir>/<task>.jsonl (the format
    benchmarks/longbench.py consumes via run.data_path), or return the
    pinned fixture when offline."""
    import json

    out = out_dir / f"{task}.jsonl"
    if out.exists():
        return out
    if not have_network():
        fixture = FIXTURES / "longbench_fixture.jsonl"
        if fixture.exists():
            print(
                f"[download] no network: using pinned fixture {fixture} "
                f"in place of LongBench/{task}", file=sys.stderr,
            )
            return fixture
        raise RuntimeError(f"no network and no cached copy of LongBench/{task}")
    from datasets import load_dataset  # type: ignore

    ds = load_dataset(LONGBENCH_REPO, task, split="test")
    out_dir.mkdir(parents=True, exist_ok=True)
    with out.open("w") as f:
        for r in ds:
            f.write(json.dumps(dict(r)) + "\n")
    return out


def fetch_model(name: str, out_dir: Path) -> Path:
    """snapshot_download a HF model for hf_loader (models/hf_loader.py)."""
    if not have_network():
        raise RuntimeError(
            f"no network: cannot fetch {name}. Point model.weights at a "
            "local checkpoint instead."
        )
    from huggingface_hub import snapshot_download  # type: ignore

    path = snapshot_download(name, cache_dir=str(out_dir))
    return Path(path)


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--dataset", help="wikitext-2 | wikitext-103 | ptb | "
                    "longbench:<task>")
    ap.add_argument("--model", help="HF model name for hf_loader")
    ap.add_argument("--out", default=str(REPO / "artifacts" / "datasets"))
    args = ap.parse_args()
    out_dir = Path(args.out)
    if args.dataset:
        if args.dataset.startswith("longbench:"):
            p = fetch_longbench_task(args.dataset.split(":", 1)[1], out_dir)
        elif args.dataset in PPL_SETS:
            p = fetch_ppl_dataset(args.dataset, out_dir)
        else:
            raise SystemExit(f"unknown dataset {args.dataset!r}")
        print(p)
    if args.model:
        print(fetch_model(args.model, out_dir / "models"))
    if not args.dataset and not args.model:
        ap.print_help()


if __name__ == "__main__":
    main()
