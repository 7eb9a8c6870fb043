"""million_tpu_torch and chip_smoke.py stand alone: neither imports JAX nor
anything of the million_tpu package (only the tests import both)."""

import re
from pathlib import Path
from types import SimpleNamespace

import pytest

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = re.compile(r"^\s*(?:import|from)\s+(?:jax\b|jaxlib\b|million_tpu(?!_torch)\b)", re.M)
SOURCES = sorted(
    p for p in (ROOT / "million_tpu_torch").rglob("*.py") if "build" not in p.parts
) + [ROOT / "chip_smoke.py"]


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax(path):
    text = path.read_text()
    assert not FORBIDDEN.search(text), f"{path.name} imports JAX or million_tpu"
    assert "importlib" not in text


def test_forbidden_pattern():
    assert FORBIDDEN.search("import jax.numpy as jnp")
    assert FORBIDDEN.search("from million_tpu.models import llama")
    assert not FORBIDDEN.search("from million_tpu_torch.models import llama")


def test_sources_cover_the_chunked_prefill_slice():
    names = {str(p.relative_to(ROOT)) for p in SOURCES}
    for rel in ("million_tpu_torch/ops/pq_encode_kernel.py",
                "million_tpu_torch/ops/pq_chunk_attention_kernel.py",
                "million_tpu_torch/models/chunked_prefill.py",
                "million_tpu_torch/runtime/generate.py", "chip_smoke.py"):
        assert rel in names, rel


def test_sources_cover_the_serving_slice():
    names = {str(p.relative_to(ROOT)) for p in SOURCES}
    for rel in ("million_tpu_torch/ops/pq_paged_attention_kernel.py",
                "million_tpu_torch/cache/paged_pq_cache.py",
                "million_tpu_torch/models/paged_decode.py",
                "million_tpu_torch/runtime/scheduler.py",
                "million_tpu_torch/benchmarks/serving_bench.py",
                "million_tpu_torch/convert.py"):
        assert rel in names, rel


def test_sources_cover_the_quality_slice():
    names = {str(p.relative_to(ROOT)) for p in SOURCES}
    for rel in ("million_tpu_torch/pq/kmeans.py", "million_tpu_torch/native.py",
                "million_tpu_torch/benchmarks/perplexity.py", "million_tpu_torch/benchmarks/tiny_lm.py",
                "million_tpu_torch/benchmarks/quality_ladder.py",
                "million_tpu_torch/utils/ledger.py"):
        assert rel in names, rel


def test_sources_cover_the_pipeline_slice():
    names = {str(p.relative_to(ROOT)) for p in SOURCES}
    for rel in ("million_tpu_torch/cli.py", "million_tpu_torch/__main__.py",
                "million_tpu_torch/utils/config.py", "million_tpu_torch/utils/fvecs.py",
                "million_tpu_torch/utils/profiling.py", "million_tpu_torch/models/hf_loader.py",
                "million_tpu_torch/benchmarks/registry.py", "million_tpu_torch/benchmarks/speedtest.py",
                "million_tpu_torch/benchmarks/longbench.py", "million_tpu_torch/benchmarks/lm_eval_adapter.py",
                "million_tpu_torch/benchmarks/eval_rows.py"):
        assert rel in names, rel


def test_sources_cover_the_multi_gpu_slice():
    names = {str(p.relative_to(ROOT)) for p in SOURCES}
    for rel in ("million_tpu_torch/parallel/distributed.py", "million_tpu_torch/parallel/mesh.py",
                "million_tpu_torch/parallel/sharded_decode.py", "million_tpu_torch/parallel/ring_attention.py",
                "million_tpu_torch/parallel/sp_prefill.py", "million_tpu_torch/parallel/paged_sharded.py",
                "million_tpu_torch/parallel/launch.py", "million_tpu_torch/dryrun.py",
                "million_tpu_torch/benchmarks/scaling_bench.py", "million_tpu_torch/benchmarks/kernel_bench.py",
                "million_tpu_torch/utils/download.py"):
        assert rel in names, rel


def test_rank_bodies_import_no_jax():
    """The spawned ranks of the mesh tests import tests/torch_mesh_ranks.py
    only: no JAX, nothing of million_tpu."""
    text = (ROOT / "tests" / "torch_mesh_ranks.py").read_text()
    assert not FORBIDDEN.search(text) and "importlib" not in text


def test_cli_imports_without_building():
    """Importing the CLI and the harnesses builds nothing and imports none of
    the optional packages (safetensors, transformers, datasets, lm_eval)."""
    import subprocess
    import sys

    code = ("import sys; import million_tpu_torch.cli, million_tpu_torch.benchmarks.eval_rows, "
            "million_tpu_torch.models.hf_loader, million_tpu_torch.utils.profiling; "
            "bad = [m for m in ('jax', 'million_tpu', 'safetensors', 'transformers', 'datasets', 'lm_eval', "
            "'triton') if m in sys.modules]; print(bad); sys.exit(1 if bad else 0)")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr[-2000:]


BANNED_IN_CUDA = ("torch/", "ATen", "cublas", "cudnn", "cutlass")


@pytest.mark.parametrize("name", ["pq_decode_attention", "pq_chunk_attention", "pq_encode",
                                  "pq_paged_attention", "causal_attention"])
def test_cuda_sources_have_a_plain_c_interface(name):
    """Each kernel source exists, exports its entry point with C linkage and
    includes neither PyTorch's headers nor a library's kernels."""
    text = (ROOT / "million_tpu_torch" / "csrc" / f"{name}.cu").read_text()
    assert f'extern "C" int {name}(' in text
    for banned in BANNED_IN_CUDA:
        assert banned not in text, banned


def test_shared_cuda_headers_are_clean_and_hashed(tmp_path, monkeypatch):
    """The headers beside the sources hold only this package's device code,
    and an edit of one changes the name of every library built from them."""
    from million_tpu_torch.ops import cuda_build

    csrc = ROOT / "million_tpu_torch" / "csrc"
    headers = sorted(csrc.glob("*.cuh"))
    assert [h.name for h in headers] == ["hopper_mma.cuh", "pq_attention_passes.cuh"]
    for h in headers:
        for banned in BANNED_IN_CUDA:
            assert banned not in h.read_text(), (h.name, banned)
    # the passes of the decode kernels; the wgmma and mbarrier helpers of the tensor-core kernels
    for header, names in (("pq_attention_passes.cuh", ("pq_decode_attention", "pq_paged_attention")),
                          ("hopper_mma.cuh", ("pq_chunk_attention", "causal_attention"))):
        for name in names:
            assert f'#include "{header}"' in (csrc / f"{name}.cu").read_text(), (name, header)

    def built_name(header_text):
        """The library name build() settles on, with nvcc and the loader stubbed."""
        (tmp_path / "k.cu").write_text("// kernel")
        (tmp_path / "h.cuh").write_text(header_text)

        def fake_nvcc(cmd, **kw):
            Path(cmd[cmd.index("-o") + 1]).write_bytes(b"")
            return SimpleNamespace(returncode=0, stdout="", stderr="")

        monkeypatch.setattr(cuda_build, "CSRC", tmp_path)
        monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "build")
        monkeypatch.setattr(cuda_build, "_LOADED", {})
        monkeypatch.setattr(cuda_build, "find_nvcc", lambda: "nvcc")
        monkeypatch.setattr(cuda_build.subprocess, "run", fake_nvcc)
        monkeypatch.setattr(cuda_build.ctypes, "CDLL", lambda path: path)
        return cuda_build.build("k").path.name

    first = built_name("// a")
    assert built_name("// a") == first
    assert built_name("// b") != first


def test_modules_import_without_building():
    """Importing the kernel modules builds nothing and needs no nvcc."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("with a card, an earlier test of this process may have built the kernels")
    from million_tpu_torch.models import chunked_prefill  # noqa: F401
    from million_tpu_torch.models import paged_decode  # noqa: F401
    from million_tpu_torch.ops import (causal_attention_kernel, pq_attention_kernel, pq_chunk_attention_kernel,
                                       pq_encode_kernel, pq_paged_attention_kernel)
    from million_tpu_torch.runtime import scheduler  # noqa: F401
    from million_tpu_torch.benchmarks import quality_ladder  # noqa: F401

    for mod in (causal_attention_kernel, pq_attention_kernel, pq_chunk_attention_kernel, pq_encode_kernel,
                pq_paged_attention_kernel):
        assert mod._lib is None
