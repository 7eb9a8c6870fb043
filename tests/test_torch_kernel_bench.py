"""The port's kernel_bench (million_tpu_torch/benchmarks/kernel_bench.py) on
the CPU, where the one-layer decode entry (B2) runs its plain version: its
parity part holds B2 against SDPA over the decoded K / V; here the same
codes also go through million_tpu's f32 oracle, at 1e-5."""

import jax.numpy as jnp
import numpy as np
import torch

from million_tpu.ops.pq_attention_ref import pq_decode_attention_ref as j_oracle
from million_tpu_torch.benchmarks import kernel_bench as kb
from million_tpu_torch.ops.pq_attention_kernel import pq_codes_attention


def test_parity_part_matches_reference_oracle():
    bs, nh_k, G, d, M, C, n = 1, 2, 3, 32, 16, 64, 300
    res = kb.parity(bs, nh_k, G, d, M, C, n, seed=5, device="cpu")
    assert res["n_codes"] == n - 100 and res["mae"] < 1e-6
    # the same draws as kb.parity, through million_tpu's oracle (empty residual window)
    rng = np.random.default_rng(5)
    kcent = rng.standard_normal((M, C, d // M)).astype(np.float32)
    vcent = rng.standard_normal((M, C, d // M)).astype(np.float32)
    q = (rng.standard_normal((bs, nh_k, G, d)) / np.sqrt(d)).astype(np.float32)
    kc = rng.integers(0, C, (bs, nh_k, n, M)).astype(np.uint8)
    vc = rng.integers(0, C, (bs, nh_k, n, M)).astype(np.uint8)
    want = j_oracle(jnp.asarray(q.reshape(bs, nh_k * G, d) * np.sqrt(d)), jnp.asarray(np.swapaxes(kc, -1, -2)),
                    jnp.asarray(np.swapaxes(vc, -1, -2)), jnp.asarray(kcent), jnp.asarray(vcent),
                    jnp.zeros((bs, nh_k, 4, d)), jnp.zeros((bs, nh_k, 4, d)), jnp.asarray(n - 100),
                    jnp.asarray(0))
    t = torch.from_numpy
    got, _ = pq_codes_attention(t(q), t(kc), t(vc), t(kcent), t(vcent), n - 100)
    np.testing.assert_allclose(got.numpy().reshape(bs, nh_k * G, d), np.asarray(want), atol=1e-5)


def test_bench_runs_the_plain_version_when_asked():
    r = kb.bench(bs=1, nh_k=2, G=2, d=16, M=8, nbits=5, n=512, parity_n=256, iters=1, outliers=4, device="cpu")
    assert r["mae"] < 1e-6 and r["kernel_ms"] > 0 and r["dense_ms"] > 0 and r["outlier_ms"] > 0
    assert r["C"] == 32 and r["G"] == 2
    assert r["timed_max_abs_err"] == 0 and r["outlier_max_abs_err"] == 0  # the wrapper is the plain version here


def test_main_prints_the_protocol(capsys):
    kb.main(["--device", "cpu", "--n", "512", "--parity-n", "256", "--iters", "1", "--heads", "1",
             "--group", "2", "--d", "16", "--M", "8", "--nbits", "4"])
    out = capsys.readouterr().out
    assert "parity n=156" in out and "dense bf16 attention" in out
