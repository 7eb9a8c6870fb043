"""benchmarks/long_context_bench.py at test-tiny on the CPU: the code arena
holds exactly ctx tokens (its random tile divides the arena, the reference's
guard, million_tpu/benchmarks/long_context_bench.py:121-125), the counters
start at ctx - 512, and each geometry's JSON line has its fields. Times from
a CPU run are not device numbers; the line's `card` says so."""

import json

import pytest
import torch

from million_tpu_torch.benchmarks import long_context_bench as LCB
from million_tpu_torch.models import llama


@pytest.mark.parametrize("ctx", [2048, 1536, 1100])
def test_code_arena_holds_ctx_tokens(ctx):
    gen = torch.Generator().manual_seed(0)
    arena = LCB.code_arena((2, 1, 3, ctx, 8), 256, gen, torch.device("cpu"))
    assert arena.shape == (2, 1, 3, ctx, 8) and arena.dtype == torch.uint8
    tile = {2048: 1024, 1536: 512, 1100: 4}[ctx]
    assert torch.equal(arena[..., :tile, :], arena[..., ctx - tile:, :])


def test_make_cache_and_reset():
    cfg = llama.PRESETS["test-tiny"]
    cache, cents = LCB.make_cache(cfg, "dm4_outlier_c128", 2048, 1, torch.device("cpu"), 0)
    assert cache["key_codes"].shape[3] == 2048 and cache["key_outliers"].shape[3] == 2048
    assert int(cache["key_codes"].max()) < 128 and cents["key"].shape[2] == 128
    LCB.reset(cache, 2048)
    assert (cache["n_codes"], cache["r"]) == (2048 - 512, 0)
    dense, none = LCB.make_cache(cfg, "dense", 2048, 1, torch.device("cpu"), 0)
    assert none is None and dense["k"].shape[3] == 2048 and float(dense["k"].abs().sum()) > 0
    assert LCB.reset(dense, 2048)["length"] == 1536
    sizes = LCB.arena_bytes(llama.PRESETS["llama-3.2-3b"], "dm2", 131072, 1)
    assert sizes["dense_bytes"] == 2 * 28 * 8 * 131072 * 128 * 2  # 15.0 GB
    assert 3.7e9 < sizes["cache_bytes"] < 3.8e9  # dm2's arena at 128K: 3.76 GB of codes


def test_main_prints_a_line_per_geometry(capsys):
    LCB.main(["--device", "cpu", "--preset", "test-tiny", "--ctx", "2048", "--geometry", "dense,dm2",
              "--iters", "3", "--repeats", "2", "--ttft-chunk", "512"])
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines() if ln.startswith("{")]
    assert [ln["geometry"] for ln in lines] == ["dense", "dm2"]
    for ln in lines:
        for key in ("metric", "value", "unit", "ctx", "bs", "cache_bytes", "dense_bytes", "tpot_ms_p10",
                    "tpot_ms_p50", "tpot_ms_p90", "tpot_ms_samples", "tokens_per_s", "card"):
            assert key in ln, key
        assert ln["ctx"] == 2048 and ln["unit"] == "ms/token" and len(ln["tpot_ms_samples"]) == 2
        assert ln["tpot_ms_p10"] <= ln["tpot_ms_p50"] <= ln["tpot_ms_p90"]
        assert ln["card"].startswith("cpu")
    assert "ttft_s" in lines[1] and "ttft_s" not in lines[0]  # a chunked prefill is PQ only
    assert lines[1]["cache_bytes"] < lines[0]["cache_bytes"] == lines[0]["dense_bytes"]


def test_rejects_a_chain_that_fills_the_window():
    cfg = llama.PRESETS["test-tiny"]
    params = llama.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(ValueError, match="residual window"):
        LCB.run_geometry(params, cfg, "dm2", ctx=1024, iters=200, device="cpu")
