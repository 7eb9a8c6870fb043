"""The pipeline CLI of the port, the counterpart of million_tpu/cli.py
(the reference's main_pq.py).

    python -m million_tpu_torch.cli -f configs/llama-3.2-3b.json \\
        -p baseline sampling training evaluation [-o key=value ...] [--device cpu]

It reads the same configs/*.json as million_tpu.cli. Stages:
  baseline    benchmark the model with the dense bf16 KV cache;
  sampling    collect KV head vectors into .fvecs files for codebook training
              (dense prefills over the dataset; the cache is the collection
              point, flattened head-major then token as million_tpu does, so
              both packages sample the same rows of the same numbers);
  training    per-layer codebooks -> a centroid .npz that either package
              loads: k-means on the card (pq/kmeans.py, every Lloyd
              assignment through the encode kernel), or the native host
              trainer (pq.native_trainer), OPQ rotations (pq.opq), exact
              outlier channels (pq.outlier_k / pq.outlier_v);
  evaluation  benchmark with the PQ cache; run.mode "pq_pallas" (the
              reference's kernel mode, configs/default.json) runs the port's
              "pq_kernel". Rows go to the port's ledger, results_torch.jsonl,
              with the mode that ran, the backend and the attention route
              (pq.nbits 9-12 give int16 arenas, whose decode attention takes
              the plain "pq" route, as in the reference package).

Benchmark kinds follow run.dataset: `_synthetic` the speedtest (TTFT / TPOT
per prefill length), a .txt / .npy file or wikitext / ptb the perplexity,
`longbench:<task>` with run.data_path a local JSONL, `lm_eval:<file.jsonl>`
(or `lm_eval:task:<name>` with the lm_eval package).

Runs on the card unless --device cpu is given; without a card it raises.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

from million_tpu_torch import resolve_device
from million_tpu_torch.benchmarks.perplexity import perplexity
from million_tpu_torch.benchmarks.registry import load_tokenizer, load_tokens, select_benchmark
from million_tpu_torch.benchmarks.speedtest import speedtest
from million_tpu_torch.cache.dense_cache import DenseCacheConfig, init_dense_state
from million_tpu_torch.cache.pq_cache import PQCacheConfig, init_state
from million_tpu_torch.convert import cents_from_numpy
from million_tpu_torch.models import llama
from million_tpu_torch.pq.kmeans import train_opq, train_pq
from million_tpu_torch.pq.ops import select_outlier_channels, zero_channels
from million_tpu_torch.utils.config import Config, load_config
from million_tpu_torch.utils.fvecs import reservoir_sample_fvecs, write_fvecs
from million_tpu_torch.utils.ledger import RESULTS, append_result

DEFAULTS = {
    "model": {"preset": "tinyllama-1.1b", "weights": None, "tokenizer": "byte", "seed": 0},
    # sample_target / train_samples None -> 256 * 2^nbits rows a layer, the
    # reference's codebook budget (main_pq.py:197)
    "pq": {"M": None, "nbits": 8, "M_v": None, "nbits_v": None, "Lt": 128,
           "train_samples": None,
           "opq": False, "native_trainer": False, "train_iters": 25,
           "sample_target": None},
    "cache": {"N_max": 32768},
    "run": {
        "dataset": "_synthetic",
        "data_path": None,
        "max_length": 2048,
        "max_windows": 4,
        "max_samples": None,
        "prefill_lengths": [1024, 4096],
        "decode_length": 64,
        "mode": "pq_kernel",
        "breakdown": False,
        "results": RESULTS,
        "artifacts": "artifacts",
    },
}

MODES = {"pq_pallas": "pq_kernel"}  # the reference's kernel mode -> the port's


def log(*a):
    print("[million-tpu-torch]", *a, file=sys.stderr, flush=True)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def build_model(cfg: Config, device="cuda"):
    dev = resolve_device(device)
    mcfg = llama.PRESETS[cfg.model.preset]
    if cfg.model.weights:
        from million_tpu_torch.models.hf_loader import load_hf_weights

        params = load_hf_weights(cfg.model.weights, mcfg, dtype=mcfg.dtype, device=dev)
        log(f"loaded weights from {cfg.model.weights}")
    else:
        params = llama.init_params(mcfg, torch.Generator(device=dev).manual_seed(int(cfg.model.seed)),
                                   device=dev)
        log(f"random weights for preset {cfg.model.preset} (synthetic mode)")
    return mcfg, params


def art_dir(cfg: Config) -> Path:
    d = Path(cfg.run.artifacts) / cfg.model.preset / Path(cfg.run.dataset).name
    d.mkdir(parents=True, exist_ok=True)
    return d


def pq_m(cfg: Config, mcfg) -> int:
    return cfg.pq.M or mcfg.head_dim // 2


def pq_geometry(cfg: Config, mcfg):
    """Per-side (M_k, nbits_k, M_v, nbits_v): V defaults to K's; pq.M_v /
    pq.nbits_v opt into the asymmetric geometry (quality-degrading)."""
    M_k, nb_k = pq_m(cfg, mcfg), cfg.pq.nbits
    M_v = cfg.pq.get("M_v") or M_k
    nb_v = cfg.pq.get("nbits_v") or nb_k
    if (M_v, nb_v) != (M_k, nb_k) and not getattr(pq_geometry, "_warned", False):
        pq_geometry._warned = True
        log("WARNING: asymmetric V-side geometry (pq.M_v/pq.nbits_v) is EXPERIMENTAL and "
            "quality-degrading (the reference's ladder measured Δppl +1.83 for K d_m=2 / V d_m=4 "
            "against +0.47 symmetric, docs/PERF.md). Use for research sweeps only.")
    return M_k, nb_k, M_v, nb_v


def outlier_geometry(cfg) -> tuple:
    """(OK, OV) exact outlier channels a side (pq.outlier_k / pq.outlier_v)."""
    return (int(cfg.pq.get("outlier_k") or 0), int(cfg.pq.get("outlier_v") or 0))


def sample_budget(cfg: Config, mcfg) -> int:
    """256 rows per centroid of the finest codebook in play (the
    reference's budget, main_pq.py:197)."""
    _, nb_k, _, nb_v = pq_geometry(cfg, mcfg)
    return 256 * (2 ** max(nb_k, nb_v))


def pq_cache_config(cfg, mcfg, bs=1, n_max=None) -> PQCacheConfig:
    """The flat PQ cache of the run: C from the wider side's codebook, so a
    side at nbits 9-12 gets int16 arenas (pq_cache.wide_codes)."""
    M_k, nb_k, M_v, nb_v = pq_geometry(cfg, mcfg)
    OK, OV = outlier_geometry(cfg)
    return PQCacheConfig(bs=bs, nh_k=mcfg.num_kv_heads, d=mcfg.head_dim, M=M_k, M_v=M_v,
                         C=2 ** max(nb_k, nb_v), Lt=cfg.pq.Lt, N_max=n_max or cfg.cache.N_max, OK=OK, OV=OV)


def make_pq_cache_factory(cfg, mcfg, bs=1, n_max=None, device="cuda"):
    dev = resolve_device(device)
    pqc = pq_cache_config(cfg, mcfg, bs, n_max)
    return lambda *_: init_state(pqc, mcfg.num_layers, device=dev)


def make_dense_cache_factory(cfg, mcfg, bs=1, n_max=None, device="cuda"):
    dev = resolve_device(device)
    dc = DenseCacheConfig(bs=bs, nh_k=mcfg.num_kv_heads, d=mcfg.head_dim, N_max=n_max or cfg.cache.N_max)
    return lambda *_: init_dense_state(dc, mcfg.num_layers, device=dev)


def _factory(cfg, mcfg, mode, device, n_max=None):
    make = make_dense_cache_factory if mode == "dense" else make_pq_cache_factory
    return make(cfg, mcfg, n_max=n_max, device=device)


def cents_path(cfg: Config, mcfg) -> Path:
    M_k, nb_k, M_v, nb_v = pq_geometry(cfg, mcfg)
    name = f"cents_M{M_k}_nbits{nb_k}"
    if (M_v, nb_v) != (M_k, nb_k):
        name += f"_V{M_v}_{nb_v}"
    if cfg.pq.get("opq"):
        name += "_opq"
    OK, OV = outlier_geometry(cfg)
    if OK or OV:
        name += f"_ok{OK}_ov{OV}"
    return art_dir(cfg) / f"{name}.npz"


def synthetic_cents(cfg: Config, mcfg) -> dict:
    """The reference's `_synthetic` fallback (main_pq.py:252-255), numpy
    arrays drawn in million_tpu.cli.load_cents's order: codebooks, outlier
    channels (their centroid components zeroed), QR rotations with pq.opq.
    Both packages build bit-identical tables from it."""
    rng = np.random.default_rng(0)
    M_k, nb_k, M_v, nb_v = pq_geometry(cfg, mcfg)
    OK, OV = outlier_geometry(cfg)
    d, L = mcfg.head_dim, mcfg.num_layers
    ck = rng.standard_normal((L, M_k, 2**nb_k, d // M_k)).astype(np.float32)
    cv = rng.standard_normal((L, M_v, 2**nb_v, d // M_v)).astype(np.float32)
    cents = {}
    if OK:
        kidx = np.sort(rng.choice(d, OK, replace=False)).astype(np.int32)
        for c in kidx:  # strided layout: channel c -> subspace c % M, component c // M
            ck[:, c % M_k, :, c // M_k] = 0.0
        cents["k_outlier_idx"] = np.stack([kidx] * L)
    if OV:
        vidx = np.sort(rng.choice(d, OV, replace=False)).astype(np.int32)
        for c in vidx:
            cv[:, c % M_v, :, c // M_v] = 0.0
        cents["v_outlier_idx"] = np.stack([vidx] * L)
    cents["key"], cents["value"] = ck, cv
    if cfg.pq.get("opq"):
        # random orthogonal rotations, so that the run takes the rotated-cache path
        cents["Rk"] = np.linalg.qr(rng.standard_normal((L, d, d)))[0].astype(np.float32)
        cents["Rv"] = np.linalg.qr(rng.standard_normal((L, d, d)))[0].astype(np.float32)
    return cents


def load_cents(cfg: Config, mcfg, device="cuda"):
    """The trained artifact at cents_path (either package's), else the
    `_synthetic` random tables, as the port's tables on `device`."""
    path = cents_path(cfg, mcfg)
    if path.exists():
        with np.load(path) as z:
            cents = {k: z[k] for k in ("key", "value", "Rk", "Rv", "k_outlier_idx", "v_outlier_idx")
                     if k in z}
        log(f"loaded centroids {path}")
    else:
        cents = synthetic_cents(cfg, mcfg)
        log(f"no trained centroids at {path}; using random codebooks (_synthetic)")
    return cents_from_numpy(cents, device=device)


def run_benchmark(cfg: Config, mcfg, params, mode: str, cents):
    dev = params["embed"].device
    mode = MODES.get(mode, mode)
    kind = select_benchmark(cfg.run.dataset)
    if kind == "speedtest":
        return speedtest(params, mcfg, _factory(cfg, mcfg, mode, dev), cents, mode=mode,
                         prefill_lengths=list(cfg.run.prefill_lengths), decode_length=cfg.run.decode_length,
                         breakdown=bool(cfg.run.get("breakdown")))
    if kind == "perplexity":
        tokens = load_tokens(cfg.run.dataset, tokenizer=load_tokenizer(cfg.model.tokenizer),
                             vocab_size=mcfg.vocab_size)
        return perplexity(params, mcfg, tokens, _factory(cfg, mcfg, mode, dev, n_max=cfg.run.max_length),
                          cents, mode=mode, max_length=cfg.run.max_length, max_windows=cfg.run.max_windows)
    if kind == "longbench":
        return run_longbench(cfg, mcfg, params, mode, cents)
    if kind == "lm_eval":
        return run_lm_eval(cfg, mcfg, params, mode, cents)
    raise NotImplementedError(f"benchmark kind {kind} (dataset {cfg.run.dataset})")


def run_longbench(cfg: Config, mcfg, params, mode: str, cents):
    """LongBench generate-and-score (the reference's pred_long_bench): a
    fresh cache per request, the task prompt, middle truncation, greedy
    generation of dataset2maxlen tokens."""
    from million_tpu_torch.benchmarks.longbench import dataset2maxlen, load_longbench_rows, pred_longbench
    from million_tpu_torch.runtime.generate import generate
    from million_tpu_torch.runtime.sampling import SamplingConfig

    dev = params["embed"].device
    task = cfg.run.dataset.split(":", 1)[1]
    tok = load_tokenizer(cfg.model.tokenizer)
    rows = load_longbench_rows(task, cfg.run.data_path)
    maxgen = dataset2maxlen[task]
    n_max = cfg.cache.N_max
    if n_max - maxgen - 4 <= 0:
        raise ValueError(f"cache.N_max={n_max} cannot hold {task}'s generation budget ({maxgen} new "
                         f"tokens) plus any prompt; raise cache.N_max")
    factory = _factory(cfg, mcfg, mode, dev, n_max=n_max)
    greedy = SamplingConfig(temperature=0.0)

    def generate_fn(prompt: str, max_new: int) -> str:
        ids = np.asarray(tok(prompt)["input_ids"][: n_max - maxgen - 4], np.int64) % mcfg.vocab_size
        res, _ = generate(params, mcfg, torch.from_numpy(ids)[None].to(dev), factory(), cents, mode=mode,
                          max_new_tokens=max_new, sampling=greedy, device=dev)
        return tok.decode(res.tokens[0].tolist())

    return pred_longbench(generate_fn, tok, task, rows, max_length=min(cfg.run.max_length, n_max - maxgen - 4),
                          max_samples=cfg.run.max_samples)


def run_lm_eval(cfg: Config, mcfg, params, mode: str, cents):
    """Loglikelihood multiple-choice accuracy. `lm_eval:<path.jsonl>` rows
    are pre-tokenized ({context_ids, choices_ids, label}) or text ({context,
    choices, label}); `lm_eval:task:<name>` runs the lm_eval harness."""
    from million_tpu_torch.benchmarks.lm_eval_adapter import evaluate_multiple_choice, make_lm_eval_model

    dev = params["embed"].device
    spec = cfg.run.dataset.split(":", 1)[1]
    tok = load_tokenizer(cfg.model.tokenizer)
    factory = _factory(cfg, mcfg, mode, dev)
    if spec.startswith("task:"):
        lm = make_lm_eval_model(params, mcfg, factory, cents, tok, mode=mode)
        import lm_eval  # type: ignore

        return lm_eval.simple_evaluate(model=lm, tasks=[spec[5:]])["results"]
    rows = [json.loads(l) for l in Path(cfg.run.data_path or spec).read_text().splitlines() if l.strip()]
    examples = []
    for r in rows[: cfg.run.max_samples]:
        if "context_ids" in r:
            examples.append(r)
        else:
            examples.append({
                "context_ids": [i % mcfg.vocab_size for i in tok(r["context"])["input_ids"]],
                "choices_ids": [[i % mcfg.vocab_size for i in tok(c)["input_ids"]] for c in r["choices"]],
                "label": r["label"],
            })
    return evaluate_multiple_choice(params, mcfg, factory, cents, examples, mode=mode)


def _record(cfg, stage, mode, res, dev, **extra):
    append_result(cfg.run.results, {"stage": stage, "backend": dev.type, "mode": mode, "result": res,
                                    **extra, "config": cfg.to_dict()})


def stage_baseline(cfg, mcfg, params):
    res = run_benchmark(cfg, mcfg, params, "dense", None)
    _record(cfg, "baseline", "dense", res, params["embed"].device)
    log("baseline:", res)
    return res


def stage_sampling(cfg, mcfg, params):
    """Per-layer KV samples (the reference's sampling stage, main_pq.py:
    168-205): dense prefills over the dataset's windows, a random subset of
    each window's head vectors appended to layer{L}.{key,value}.fvecs until
    sample_target rows a layer."""
    dev = params["embed"].device
    tokens = load_tokens(cfg.run.dataset, tokenizer=load_tokenizer(cfg.model.tokenizer),
                         vocab_size=mcfg.vocab_size)
    target = cfg.pq.sample_target or sample_budget(cfg, mcfg)
    out = art_dir(cfg)
    for L in range(mcfg.num_layers):
        (out / f"layer{L}.key.fvecs").unlink(missing_ok=True)
        (out / f"layer{L}.value.fvecs").unlink(missing_ok=True)
    collected, w = 0, 0
    wlen = cfg.run.max_length
    rng = np.random.default_rng(0)
    factory = make_dense_cache_factory(cfg, mcfg, n_max=wlen, device=dev)
    while collected < target and (w + 1) * wlen <= len(tokens):
        ids = torch.from_numpy(np.asarray(tokens[w * wlen:(w + 1) * wlen], np.int64)[None]).to(dev)
        cache = factory()
        llama.prefill(params, mcfg, ids, cache, None, mode="dense", last_logit_only=True)
        keep = min(wlen * mcfg.num_kv_heads, target - collected)
        for L in range(mcfg.num_layers):
            # (nh_k, wlen, d) -> rows head-major then token, as million_tpu flattens them
            k = cache["k"][L, 0, :, :wlen].float().cpu().numpy().reshape(-1, mcfg.head_dim)
            v = cache["v"][L, 0, :, :wlen].float().cpu().numpy().reshape(-1, mcfg.head_dim)
            sel = rng.choice(len(k), size=keep, replace=False)
            write_fvecs(out / f"layer{L}.key.fvecs", k[sel])
            write_fvecs(out / f"layer{L}.value.fvecs", v[sel])
        collected += keep
        w += 1
        log(f"sampling: {collected}/{target} rows/layer")
    if collected < target:
        log(f"warning: dataset exhausted at {collected} rows/layer")
    return {"rows_per_layer": collected, "windows": w,
            "bytes": sum(p.stat().st_size for p in out.glob("layer*.fvecs"))}


def stage_training(cfg, mcfg, params=None):
    """Per-layer codebooks (the reference's training stage, main_pq.py:
    208-242) in the strided subspace layout the kernels read, saved as
    np.savez(key, value[, Rk, Rv][, k_outlier_idx, v_outlier_idx])."""
    dev = params["embed"].device if params is not None else resolve_device("cuda")
    out = art_dir(cfg)
    M_k, nb_k, M_v, nb_v = pq_geometry(cfg, mcfg)
    opq = bool(cfg.pq.get("opq"))
    native = bool(cfg.pq.get("native_trainer"))
    if native and opq:
        raise ValueError("pq.native_trainer covers plain PQ only (no OPQ)")
    OK, OV = outlier_geometry(cfg)
    if (OK or OV) and opq:
        raise ValueError("pq.outlier_k/outlier_v do not compose with OPQ (outlier channels are defined "
                         "in the original basis; the rotation would smear them)")
    iters = cfg.pq.train_iters
    if native:
        # host threads (csrc/pqlib.cpp), the role faiss-cpu plays in the reference
        from million_tpu_torch.native import train_pq_native

        def train_k(x, M, nb):
            return train_pq_native(x.cpu().numpy(), M=M, nbits=nb, iters=iters, layout="strided")
    else:
        def train_k(x, M, nb):
            return train_pq(x, M=M, nbits=nb, iters=iters, layout="strided").cpu().numpy()

    keys, vals, rks, rvs, kidxs, vidxs, seconds = [], [], [], [], [], [], []
    # one pass over each sample file at O(train_samples) memory
    cap = int(cfg.pq.train_samples or sample_budget(cfg, mcfg))
    for L in range(mcfg.num_layers):
        ks = torch.from_numpy(reservoir_sample_fvecs(out / f"layer{L}.key.fvecs", cap, seed=L)).to(dev)
        vs = torch.from_numpy(reservoir_sample_fvecs(out / f"layer{L}.value.fvecs", cap, seed=1000 + L)).to(dev)
        if OK:  # top-energy channels, zeroed before k-means and stored exact at run time
            kidx = select_outlier_channels(ks, OK)
            ks = zero_channels(ks, kidx)
            kidxs.append(kidx.cpu().numpy())
        if OV:
            vidx = select_outlier_channels(vs, OV)
            vs = zero_channels(vs, vidx)
            vidxs.append(vidx.cpu().numpy())
        t = []
        for x, M, nb, cb, rots in ((ks, M_k, nb_k, keys, rks), (vs, M_v, nb_v, vals, rvs)):
            _sync(dev)
            t0 = time.perf_counter()
            if opq:  # rotation and codebooks trained together (OPQ-NP)
                R, c = train_opq(x, M=M, nbits=nb, iters=iters, layout="strided")
                rots.append(R.cpu().numpy())
                cb.append(c.cpu().numpy())
            else:
                cb.append(train_k(x, M, nb))
            _sync(dev)
            t.append(time.perf_counter() - t0)
        seconds.append(t)
        log(f"training: layer {L} codebooks done ({len(ks)} samples; {t[0]:.3f} s K, {t[1]:.3f} s V)")
    path = cents_path(cfg, mcfg)
    arrays = {"key": np.stack(keys), "value": np.stack(vals)}
    if opq:
        arrays["Rk"], arrays["Rv"] = np.stack(rks), np.stack(rvs)
    if kidxs:
        arrays["k_outlier_idx"] = np.stack(kidxs).astype(np.int32)
    if vidxs:
        arrays["v_outlier_idx"] = np.stack(vidxs).astype(np.int32)
    np.savez(path, **arrays)
    log(f"saved centroids to {path}")
    return {"path": str(path), "samples": int(len(ks)), "seconds_per_layer_side": seconds}


def stage_evaluation(cfg, mcfg, params):
    dev = params["embed"].device
    mode = MODES.get(cfg.run.mode, cfg.run.mode)
    path = cents_path(cfg, mcfg)
    centroids = str(path) if path.exists() else "_synthetic"  # the row names the tables it ran on
    tables = load_cents(cfg, mcfg, device=dev)
    # the decode attention the run takes: "pq" where wide (int16) codes leave "pq_kernel" no kernel
    route = llama.attention_route(pq_cache_config(cfg, mcfg).code_dtype, mode) if mode != "dense" else mode
    res = run_benchmark(cfg, mcfg, params, mode, tables)
    _record(cfg, "evaluation", mode, res, dev, centroids=centroids, attention_route=route)
    log("evaluation:", res)
    return res


STAGES = {
    "baseline": stage_baseline,
    "sampling": stage_sampling,
    "training": stage_training,
    "evaluation": stage_evaluation,
}


def main(argv=None):
    """Run the stages in order; returns {stage: (its result, its wall s)}."""
    ap = argparse.ArgumentParser(prog="million_tpu_torch.cli")
    ap.add_argument("-f", "--config", action="append", default=[], help="JSON config file(s)")
    ap.add_argument("-p", "--pipelines", nargs="+", default=["evaluation"], choices=list(STAGES),
                    help="stages to run, in order")
    ap.add_argument("-o", "--override", action="append", default=[], dest="overrides",
                    help="dotted key=value override (repeatable)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = load_config(args.config, args.overrides, base=DEFAULTS)
    mcfg, params = build_model(cfg, device=dev)
    out = {}
    for stage in args.pipelines:
        log(f"=== stage: {stage} ===")
        t0 = time.perf_counter()
        res = STAGES[stage](cfg, mcfg, params)
        _sync(dev)
        out[stage] = (res, time.perf_counter() - t0)
        log(f"stage {stage}: {out[stage][1]:.2f} s wall")
    return out


if __name__ == "__main__":
    main()
