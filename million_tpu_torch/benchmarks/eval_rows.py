"""Measured LongBench and lm-eval rows on the byte-LM quality anchor.

Counterpart of million_tpu/benchmarks/eval_rows.py, over the port: the same
task rows and multiple-choice items (numpy, from the same corpus array and
seed), codebooks trained on the anchor's own K/V by the port's k-means
(quality_ladder.sample_kv / train_cents), the LongBench harness
(longbench.py) and the hermetic lm-eval battery (lm_eval_adapter.py), dense
KV against PQ. On the card the PQ rows run mode "pq_kernel" (the decode
kernel) where the reference runs "pq_pallas"; on the CPU the oracle "pq".
Rows go to the port's ledger, results_torch.jsonl.

Task construction (as in the reference): LongBench rows in the release JSONL
schema built from the held-out region of the corpus the LM was trained on
(`lcc` next-line code completion, `passage_count`, `passage_retrieval_en`,
`repobench-p`, the synthetic `needle_retrieval`); the lm-eval battery is
4-way multiple choice (true 48-byte continuation against 3 distractors from
distant offsets) and an optional word cloze. Prompts within a task have one
fixed byte length.

Run:  python -m million_tpu_torch.benchmarks.eval_rows [--device cpu] [--small]
"""

from __future__ import annotations

import argparse
import re
import sys
from typing import List

import numpy as np
import torch


def log(*a):
    print(*a, file=sys.stderr, flush=True)


class ByteTokenizer:
    """LongBench-harness-compatible byte tokenizer (latin-1 <-> ids)."""

    def __call__(self, s: str, **kw):
        return {"input_ids": list(s.encode("latin-1", errors="replace"))}

    def decode(self, ids):
        return bytes(int(i) & 0xFF for i in ids).decode("latin-1")


def _text(a: np.ndarray) -> str:
    """Corpus slice (int32 byte values) -> str."""
    return a.astype(np.uint8).tobytes().decode("latin-1")


def _at(corpus: np.ndarray, o: int, n: int) -> np.ndarray:
    """Fixed-size corpus slice, position wrapped to stay in bounds (the
    small smoke corpus is only a few MB)."""
    o = o % max(len(corpus) - n - 1, 1)
    return corpus[o : o + n]


def _paragraphs(corpus: np.ndarray, start: int, k: int, size: int) -> List[str]:
    """k distinct fixed-size text chunks from the corpus byte stream."""
    out = []
    for j in range(k):
        o = start + j * (size + 997)
        out.append(_text(_at(corpus, o, size)))
    return out


def build_task_rows(corpus: np.ndarray, task: str, n_rows: int, rng,
                    ctx_bytes: int = 3072) -> List[dict]:
    """LongBench release-schema rows ({context, input, answers,
    all_classes, ...}) with fixed prompt lengths per task. `ctx_bytes`
    scales the code tasks' context (round 5: rows at several context
    lengths measure quality as more conditioning flows through the
    compressed cache)."""
    base = max(len(corpus) - 4_000_000, len(corpus) // 2)  # held-out tail
    rows = []
    for r in range(n_rows):
        if task == "lcc":
            o = (base + r * 37_013) % max(len(corpus) - 4096 - ctx_bytes, 1)
            # context ends exactly at a newline; answer = the next line
            span = corpus[o : o + ctx_bytes]
            nl = np.where(span == 10)[0]
            end = int(nl[-1]) + 1 if len(nl) else len(span)
            ctx = _text(corpus[o : o + end])
            ctx = ctx.rjust(ctx_bytes)  # fixed prompt length (left-pad)
            rest = _text(corpus[o + end : o + end + 256])
            answer = rest.split("\n", 1)[0][:64]
            rows.append({"context": ctx, "input": "", "answers": [answer],
                         "all_classes": None})
        elif task == "passage_count":
            k_unique = int(rng.integers(2, 6))
            paras = _paragraphs(corpus, base + 1_000_000 + r * 61_001,
                                k_unique, 256)
            seq = paras + [paras[i % k_unique] for i in range(7 - k_unique)]
            rng.shuffle(seq)
            ctx = "\n\n".join(seq)
            rows.append({"context": ctx.rjust(2200), "input": "",
                         "answers": [str(k_unique)], "all_classes": None})
        elif task == "passage_retrieval_en":
            paras = _paragraphs(corpus, base + 2_000_000 + r * 53_003, 8, 240)
            j = int(rng.integers(0, 8))
            ctx = "\n\n".join(
                f"Paragraph {i + 1}: {p}" for i, p in enumerate(paras)
            )
            rows.append({
                "context": ctx.rjust(2400),
                "input": paras[j][:120].ljust(120),
                "answers": [f"Paragraph {j + 1}"],
                "all_classes": None,
            })
        elif task == "needle_retrieval":
            # synthetic needle task (round 5, VERDICT r4 item 4): K
            # tag->number pairings separated by corpus filler; the query
            # repeats a far-back pairing's prefix, so the answer requires
            # retrieving it through the (compressed) KV. Scored by the
            # REAL retrieval_score. Filler digits are masked so stray
            # numbers can't pollute the fraction-of-numbers metric.
            K = 8
            letters = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz", np.uint8)
            tags = []
            while len(tags) < K:
                t = "".join(chr(c) for c in rng.choice(letters, 6))
                if t not in tags:
                    tags.append(t)
            parts = []
            for i in range(K):
                filler = _text(_at(corpus, base + 3_000_000 + (r * K + i)
                                   * 47_017, 220))
                filler = re.sub(r"\d", "o", filler)
                parts.append(
                    f"Section {tags[i]} is Paragraph {i + 1}.\n{filler}\n"
                )
            j = int(rng.integers(0, K))
            ctx = "".join(parts)
            rows.append({
                "context": ctx.rjust(2300),
                "input": f"Section {tags[j]} is Paragraph ",
                "answers": [f"Paragraph {j + 1}"],
                "all_classes": None,
            })
        elif task == "repobench-p":
            # second code task (reference repobench-p template + code_sim
            # metric; rows from a DIFFERENT source-tree region than lcc)
            o = (base + 2_500_000 + r * 43_019) % max(
                len(corpus) - 4096 - ctx_bytes, 1)
            span = corpus[o : o + ctx_bytes]
            nl = np.where(span == 10)[0]
            end = int(nl[-1]) + 1 if len(nl) else len(span)
            ctx = _text(corpus[o : o + end]).rjust(ctx_bytes)
            rest = _text(corpus[o + end : o + end + 256])
            rows.append({"context": ctx, "input": "",
                         "answers": [rest.split("\n", 1)[0][:64]],
                         "all_classes": None})
        else:
            raise ValueError(task)
    return rows


def build_mc_items(corpus: np.ndarray, n_items: int, rng,
                   ctx_len: int = 192, cont_len: int = 48) -> List[dict]:
    """4-way MC: true continuation vs 3 distant-offset distractors."""
    base = max(len(corpus) - 3_000_000, len(corpus) // 2)
    items = []
    for i in range(n_items):
        span = _at(corpus, base + i * 41_011, ctx_len + cont_len)
        ctx = span[:ctx_len].tolist()
        true = span[ctx_len:].tolist()
        choices = [true]
        for d in range(3):
            od = base + 500_000 + (i * 7 + d) * 29_009
            choices.append(_at(corpus, od, cont_len).tolist())
        label = int(rng.integers(0, 4))
        choices[0], choices[label] = choices[label], choices[0]
        items.append({"context_ids": ctx, "choices_ids": choices,
                      "label": label})
    return items


def build_cloze_items(corpus: np.ndarray, n_items: int, rng,
                      ctx_len: int = 256) -> List[dict]:
    """4-way word cloze (a second lm-eval task FAMILY beyond continuation
    ranking): the context ends at a word boundary; choices are the true
    next word vs 3 words harvested from distant corpus offsets, ranked by
    continuation loglikelihood."""
    base = max(len(corpus) - 3_500_000, len(corpus) // 2)

    def word_at(o):
        span = _at(corpus, o, 64)
        txt = _text(span)
        words = [w for w in re.split(r"[^A-Za-z]+", txt) if 3 <= len(w) <= 10]
        return words[1] if len(words) > 1 else "the"

    items = []
    for i in range(n_items):
        span = _at(corpus, base + i * 37_511, ctx_len + 64)
        txt = _text(span)
        # cut at the LAST space inside ctx_len so the context ends at a
        # word boundary and the true next word follows it
        cut = txt.rfind(" ", 0, ctx_len)
        if cut < ctx_len // 2:
            cut = ctx_len - 8
        ctx = txt[: cut + 1].rjust(ctx_len)
        true = re.split(r"[^A-Za-z]+", txt[cut + 1 :] + " x")[0] or "the"
        choices = [true]
        for d in range(3):
            w = word_at(base + 700_000 + (i * 11 + d) * 31_013)
            choices.append(w if w != true else w + "s")
        label = int(rng.integers(0, 4))
        choices[0], choices[label] = choices[label], choices[0]
        enc = lambda s: list(s.encode("latin-1", "replace"))
        items.append({"context_ids": enc(ctx),
                      "choices_ids": [enc(c) for c in choices],
                      "label": label})
    return items


def main(argv=None):
    ap = argparse.ArgumentParser(prog="million_tpu_torch.benchmarks.eval_rows")
    ap.add_argument("--out", default=None, help="ledger file (default results_torch.jsonl)")
    ap.add_argument("--rows", type=int, default=8, help="rows per task")
    ap.add_argument("--mc-items", type=int, default=64)
    ap.add_argument("--mc-ctx", nargs="*", type=int, default=[192],
                    help="context lengths for the byte-MC battery (one lm_eval row per length)")
    ap.add_argument("--cloze-items", type=int, default=0,
                    help="word-cloze items (0 = skip; a second lm-eval task family)")
    ap.add_argument("--tasks", nargs="*", default=["lcc", "passage_count", "passage_retrieval_en"])
    ap.add_argument("--code-ctx", nargs="*", type=int, default=[3072],
                    help="context lengths (bytes) for the code tasks (lcc / repobench-p): one row each")
    ap.add_argument("--small", action="store_true", help="the small d=32 anchor (fast CPU smoke)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from million_tpu_torch import resolve_device
    from million_tpu_torch.benchmarks import tiny_lm
    from million_tpu_torch.benchmarks.lm_eval_adapter import evaluate_multiple_choice
    from million_tpu_torch.benchmarks.longbench import pred_longbench
    from million_tpu_torch.benchmarks.quality_ladder import sample_kv, train_cents
    from million_tpu_torch.cache.dense_cache import DenseCacheConfig, init_dense_state
    from million_tpu_torch.cache.pq_cache import PQCacheConfig, init_state
    from million_tpu_torch.runtime.generate import generate
    from million_tpu_torch.runtime.sampling import SamplingConfig
    from million_tpu_torch.utils.ledger import RESULTS, append_result

    dev = resolve_device(args.device)
    out_path = args.out or RESULTS
    path = tiny_lm.checkpoint_path() if args.small else tiny_lm.checkpoint_path_l()
    params, cfg = tiny_lm.load_checkpoint(path, device=dev)
    anchor = path.stem
    log(f"anchor model: {anchor} ({cfg.num_layers}L d={cfg.head_dim}) on {dev}")
    corpus = tiny_lm.build_corpus() if args.small else tiny_lm.build_corpus_v2()
    rng = np.random.default_rng(args.seed)

    # codebooks from the model's own KV: the real pipeline
    M, C = cfg.head_dim // 2, 256
    kv_k, kv_v = sample_kv(params, cfg, corpus[: 8 * 512])
    cents = {"key": train_cents(kv_k, M, 8, device=dev)[0], "value": train_cents(kv_v, M, 8, device=dev)[0]}
    pq_mode = "pq_kernel" if dev.type == "cuda" else "pq"
    tok = ByteTokenizer()
    greedy = SamplingConfig(temperature=0.0)

    def dense_cache(n_max):
        return init_dense_state(DenseCacheConfig(bs=1, nh_k=cfg.num_kv_heads, d=cfg.head_dim, N_max=n_max,
                                                 dtype=cfg.dtype), cfg.num_layers, device=dev)

    def pq_cache(n_max):
        return init_state(PQCacheConfig(bs=1, nh_k=cfg.num_kv_heads, d=cfg.head_dim, M=M, C=C, Lt=128,
                                        N_max=n_max, dtype=cfg.dtype), cfg.num_layers, device=dev)

    def make_gen(mode, n_max=8192):
        def gen(prompt: str, max_new: int) -> str:
            ids = torch.from_numpy(np.frombuffer(prompt.encode("latin-1", "replace"), np.uint8)
                                   .astype(np.int64)[None]).to(dev)
            cache = dense_cache(n_max) if mode == "dense" else pq_cache(n_max)
            res, _ = generate(params, cfg, ids, cache, cents, mode=mode, max_new_tokens=max_new,
                              sampling=greedy, device=dev)
            return tok.decode(res.tokens[0])
        return gen

    gate_failures = []
    jobs = []
    for task in args.tasks:
        if task in ("lcc", "repobench-p"):
            jobs += [(task, cb) for cb in args.code_ctx]
        else:
            jobs.append((task, 3072))
    for task, ctx_bytes in jobs:
        rows = build_task_rows(corpus, task, args.rows, rng, ctx_bytes=ctx_bytes)
        n_max = 1 << max(13, (ctx_bytes + 512 - 1).bit_length())
        res, preds = {}, {}
        for mode in ("dense", pq_mode):
            captured = []
            g0 = make_gen(mode, n_max=n_max)

            def gen_capture(p, n, _g=g0, _c=captured):
                out = _g(p, n)
                _c.append(out)
                return out
            res[mode] = pred_longbench(gen_capture, tok, task, rows, max_length=ctx_bytes + 1024)
            preds[mode] = captured

        def frac(a, b):
            n = min(len(a), len(b))
            if n == 0:
                return float(len(a) == len(b))
            return sum(x == y for x, y in zip(a[:n], b[:n])) / n
        agree = float(np.mean([frac(a, b) for a, b in zip(preds["dense"], preds[pq_mode])]))
        # PQ-tracks-dense gate, only where the dense score carries signal
        gated = res["dense"]["score"] > 0.1
        ok = (not gated) or (res[pq_mode]["score"] >= res["dense"]["score"] - 0.15)
        if not ok:
            gate_failures.append(task)
        row = {
            "stage": "longbench", "backend": dev.type, "task": task, "model": anchor,
            "n": res["dense"]["n"], "ctx_bytes": ctx_bytes,
            "score_dense": round(res["dense"]["score"], 4), "score_pq": round(res[pq_mode]["score"], 4),
            "pq_mode": pq_mode, "generation_agreement": round(agree, 3), "gated": gated, "gate_ok": ok,
            "M": M, "nbits": 8,
        }
        append_result(out_path, row)
        log(f"longbench {task}@{ctx_bytes}: dense={row['score_dense']} pq={row['score_pq']} "
            f"agree={agree:.2f} {'GATED' if gated else 'ungated (dense<=0.1)'}{'' if ok else ' GATE-FAIL'}")

    def run_lm_eval_task(task_name, items, nmax):
        accs = {}
        for mode in ("dense", pq_mode):
            mk = (lambda: dense_cache(nmax)) if mode == "dense" else (lambda: pq_cache(nmax))
            accs[mode] = evaluate_multiple_choice(params, cfg, mk, cents, items,
                                                  mode="dense" if mode == "dense" else "pq")
        ok = accs[pq_mode]["acc"] >= accs["dense"]["acc"] - 0.15
        if not ok:
            gate_failures.append(task_name)
        row = {
            "stage": "lm_eval", "backend": dev.type, "task": task_name, "model": anchor,
            "n": accs["dense"]["n"], "acc_dense": round(accs["dense"]["acc"], 4),
            "acc_pq": round(accs[pq_mode]["acc"], 4), "chance": 0.25, "gate_ok": ok, "M": M, "nbits": 8,
        }
        append_result(out_path, row)
        log(f"lm_eval {task_name}: dense={row['acc_dense']} pq={row['acc_pq']} (chance 0.25, n={row['n']})"
            f"{'' if ok else ' GATE-FAIL'}")

    for ctx_len in args.mc_ctx:
        items = build_mc_items(corpus, args.mc_items, rng, ctx_len=ctx_len)
        nmax = -(-(ctx_len + 64) // 128) * 128
        run_lm_eval_task("byte_mc4" if ctx_len == 192 else f"byte_mc4_ctx{ctx_len}", items, nmax)
    if args.cloze_items:
        run_lm_eval_task("byte_cloze", build_cloze_items(corpus, args.cloze_items, rng), 384)
    if gate_failures:
        raise SystemExit(f"PQ-tracks-dense gate FAILED on: {gate_failures}")


if __name__ == "__main__":
    main()
