"""The port's trainer of the quality LMs (million_tpu_torch.benchmarks.tiny_lm)
against million_tpu's, on the CPU.

Both packages start from the same weights (million_tpu's init, carried over
by convert.py) and draw the same windows from a seeded numpy token stream.
The first step's loss and gradients agree within 1e-5 relative (the global
norm of the difference over the global norm); ten steps of training give
losses within 1e-3 relative. Parameters are compared only through the loss:
Adam's first update is lr * sign(g), which flips where g is at rounding
level. Checkpoints load across the two packages."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from million_tpu.benchmarks import tiny_lm as jt
from million_tpu.cache.dense_cache import DenseCacheConfig, init_dense_state
from million_tpu.models import llama as jl
from million_tpu_torch import convert
from million_tpu_torch.benchmarks import tiny_lm as tt
from million_tpu_torch.models import llama as tl

# QUALITY_CFG's shape at one layer: the test's own small size
JCFG = dataclasses.replace(jt.QUALITY_CFG, num_layers=1)
TCFG = dataclasses.replace(tt.QUALITY_CFG, num_layers=1)
BS, CTX, STEPS = 4, 64, 10


def np_tree(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


@pytest.fixture(scope="module")
def setup():
    jp = jl.init_params(JCFG, jax.random.PRNGKey(0))
    tokens = np.random.default_rng(3).integers(0, 256, 40000).astype(np.int32)
    return jp, tokens


def _flat(tree):
    return {k: v for k, v in tree.items() if k != "layers"} | {
        f"layers/{k}": v for k, v in tree["layers"].items()}


def test_first_step_loss_and_gradients_match(setup):
    jp, tokens = setup
    ids = np.stack([tokens[s:s + CTX] for s in (0, 500, 1000, 1500)])
    cache = init_dense_state(DenseCacheConfig(bs=BS, nh_k=JCFG.num_kv_heads, d=JCFG.head_dim,
                                              N_max=CTX, dtype=jnp.float32), JCFG.num_layers)
    lj, gj = jax.value_and_grad(jt._loss_fn)(jp, JCFG, jnp.asarray(ids), cache)
    tp = convert.params_from_numpy(np_tree(jp), torch.float32, device="cpu")
    for v in tt._leaves(tp):
        v.requires_grad_(True)
    lt = tl.loss_fn(tp, TCFG, torch.from_numpy(ids.astype(np.int64)))
    lt.backward()
    assert abs(lt.item() - float(lj)) / abs(float(lj)) < 1e-5
    gj, gt = _flat(np_tree(gj)), _flat({k: (v.grad if torch.is_tensor(v) else {kk: vv.grad for kk, vv in v.items()})
                                        for k, v in tp.items()})
    assert set(gj) == set(gt)
    diff = np.sqrt(sum(((gt[k].numpy() - gj[k]) ** 2).sum() for k in gj))
    norm = np.sqrt(sum((gj[k] ** 2).sum() for k in gj))
    assert diff / norm < 1e-5, diff / norm


def test_ten_steps_track_the_reference(setup, capsys):
    """Ten steps of both trainers from one init: every step's loss within 1e-3
    relative (the reference's printed losses, log_every=1)."""
    jp, tokens = setup
    _, jloss = jt.train_tiny_lm(tokens, JCFG, steps=STEPS, bs=BS, ctx=CTX, holdout=1000, log_every=1)
    printed = [float(ln.split("loss ")[1].split()[0]) for ln in capsys.readouterr().out.splitlines()
               if "loss" in ln]
    losses = []
    tp = convert.params_from_numpy(np_tree(jp), torch.float32, device="cpu")
    _, tloss = tt.train_tiny_lm(tokens, TCFG, steps=STEPS, bs=BS, ctx=CTX, holdout=1000, log_every=0,
                                params=tp, device="cpu", losses=losses)
    assert len(printed) == len(losses) == STEPS
    np.testing.assert_allclose(losses, printed, rtol=1e-3, atol=1e-4)  # the print has 4 decimals
    assert abs(tloss - jloss) / jloss < 1e-3


def test_schedule_and_clip_match_optax():
    import optax

    sched = optax.cosine_decay_schedule(3e-3, 50, alpha=0.1)
    for t in (0, 1, 17, 49, 50, 60):
        assert abs(tt.cosine_lr(3e-3, 50, t) - float(sched(t))) < 1e-9
    rng = np.random.default_rng(0)
    for scale in (0.1, 10.0):
        g = {"a": rng.standard_normal((3, 4)).astype(np.float32) * scale,
             "b": rng.standard_normal(5).astype(np.float32) * scale}
        want, _ = optax.clip_by_global_norm(1.0).update({k: jnp.asarray(v) for k, v in g.items()}, None)
        got = [torch.from_numpy(g["a"].copy()), torch.from_numpy(g["b"].copy())]
        tt.clip_by_global_norm(got, 1.0)
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want["a"]), rtol=1e-6)
        np.testing.assert_allclose(got[1].numpy(), np.asarray(want["b"]), rtol=1e-6)


def test_checkpoints_load_across_packages(setup, tmp_path):
    jp, _ = setup
    tp = convert.params_from_numpy(np_tree(jp), torch.float32, device="cpu")
    tt.save_checkpoint(tp, TCFG, tmp_path / "port.npz")
    jp2, jcfg = jt.load_checkpoint(tmp_path / "port.npz")
    assert jcfg == JCFG
    for k, v in _flat(np_tree(jp)).items():
        np.testing.assert_array_equal(_flat(np_tree(jp2))[k], v)
    jt.save_checkpoint(jp, JCFG, tmp_path / "ref.npz")
    tp2, tcfg = tt.load_checkpoint(tmp_path / "ref.npz", device="cpu")
    assert tcfg == TCFG
    for k, v in _flat(tp).items():
        np.testing.assert_array_equal(_flat(tp2)[k].numpy(), v.numpy())
