"""The port's mesh paths on one card (marked `cuda`; they skip without one).
The ranks share the card over gloo (all-gather and send / recv through the
host); a 1-rank group runs NCCL. This file imports no JAX: the card's
machine runs it as `python3 -m pytest tests/test_torch_mesh_cuda.py -m cuda`."""

import tempfile

import pytest
import torch


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the mesh paths' kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_dryrun_on_the_card(card):
    from million_tpu_torch.dryrun import dryrun_multichip

    res = dryrun_multichip(4, "cuda")
    assert res["routes"]["all_gather"] == "host-staged" and res["routes"]["all_reduce"] == "gloo"


@pytest.mark.cuda
def test_sharded_paths_match_one_rank_on_the_card(card):
    from million_tpu_torch.benchmarks.scaling_bench import mesh_parity

    gaps = mesh_parity("cuda")
    assert all(v < 1e-4 for v in gaps.values()), gaps


@pytest.mark.cuda
def test_one_rank_nccl_group(card):
    from million_tpu_torch.parallel import distributed
    from million_tpu_torch.parallel.mesh import make_mesh

    with tempfile.TemporaryDirectory() as tmp:
        distributed.initialize(0, 1, f"file://{tmp}/store", device="cuda")
        try:
            m = make_mesh(device="cuda")
            t = torch.arange(4.0, device=card)
            assert torch.equal(m.all_reduce(t.clone(), "seq", "max"), t)
            assert torch.equal(m.all_gather(t, "seq", 0), t)
            assert set(m.routes.values()) == {"nccl"}
        finally:
            distributed.shutdown()


@pytest.mark.cuda
def test_initialize_under_a_launcher_environment_takes_the_card(card, monkeypatch, tmp_path):
    """initialize() with its defaults and torchrun's variables set: this
    rank's LOCAL_RANK card and NCCL, and make_mesh on that card."""
    from million_tpu_torch.parallel import distributed
    from million_tpu_torch.parallel.mesh import make_mesh

    for k, v in dict(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0", LOCAL_WORLD_SIZE="1").items():
        monkeypatch.setenv(k, v)
    dev = distributed.initialize(init_method=f"file://{tmp_path}/store")
    try:
        assert dev == torch.device("cuda", 0) and distributed.backend() == "nccl"
        assert torch.cuda.current_device() == 0
        m = make_mesh()
        assert m.device == dev
        t = torch.arange(4.0, device=dev)
        assert torch.equal(m.all_reduce(t.clone(), "seq", "max"), t) and m.routes == {"all_reduce": "nccl"}
    finally:
        distributed.shutdown()
