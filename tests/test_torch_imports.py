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
