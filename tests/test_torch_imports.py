"""million_tpu_torch and chip_smoke.py stand alone: neither imports JAX nor
anything of the million_tpu package (only the tests import both)."""

import re
from pathlib import Path

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


@pytest.mark.parametrize("name", ["pq_decode_attention", "pq_chunk_attention", "pq_encode"])
def test_cuda_sources_have_a_plain_c_interface(name):
    """Each kernel source exists, exports its entry point with C linkage and
    includes neither PyTorch's headers nor a library's kernels."""
    text = (ROOT / "million_tpu_torch" / "csrc" / f"{name}.cu").read_text()
    assert f'extern "C" int {name}(' in text
    for banned in ("torch/", "ATen", "cublas", "cudnn", "cutlass"):
        assert banned not in text, banned


def test_modules_import_without_building():
    """Importing the kernel modules builds nothing and needs no nvcc."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("with a card, an earlier test of this process may have built the kernels")
    from million_tpu_torch.models import chunked_prefill  # noqa: F401
    from million_tpu_torch.ops import pq_attention_kernel, pq_chunk_attention_kernel, pq_encode_kernel

    for mod in (pq_attention_kernel, pq_chunk_attention_kernel, pq_encode_kernel):
        assert mod._lib is None
