"""million_tpu_torch.runtime.sampling: greedy matches million_tpu's, and
temperature / top-k sampling draw only allowed tokens from an explicit
generator."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from million_tpu.runtime.sampling import SamplingConfig as JS, sample as j_sample
from million_tpu_torch.runtime.sampling import SamplingConfig, sample


def test_greedy_matches_jax(rng):
    logits = rng.standard_normal((3, 50)).astype(np.float32)
    logits[1, 7] = logits[1, 9] = 10.0  # a tie goes to the first index
    want = np.asarray(j_sample(jnp.asarray(logits), jax.random.PRNGKey(0), JS()))
    got = sample(torch.from_numpy(logits)).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[1] == 7


def test_top_k_and_temperature(rng):
    logits = torch.from_numpy(rng.standard_normal((4, 50)).astype(np.float32))
    top3 = torch.topk(logits, 3, dim=-1).indices
    gen = torch.Generator().manual_seed(0)
    for _ in range(20):
        tok = sample(logits, gen, SamplingConfig(temperature=0.7, top_k=3))
        assert all(tok[i] in top3[i] for i in range(4))
    a = sample(logits, torch.Generator().manual_seed(5), SamplingConfig(temperature=1.0))
    b = sample(logits, torch.Generator().manual_seed(5), SamplingConfig(temperature=1.0))
    assert torch.equal(a, b)
    greedy = sample(logits, gen, SamplingConfig(temperature=0.5, top_k=1))
    assert torch.equal(greedy, logits.argmax(-1))
